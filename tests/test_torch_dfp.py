"""The port's DFP network, with weights converted from the JAX package,
against the JAX forward; and the .npz checkpoint format across packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dfp as jdfp
from repro_torch.convert import leaves, params_from_jax
from repro_torch.core import dfp as tdfp
from _torch_parity import PKGS, agent_pair, jax_tree_numpy

RES = [PKGS["jax"].ResourceSpec("node", 16), PKGS["jax"].ResourceSpec("bb", 8)]
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    state = rng.uniform(0, 1, (b, cfg.state_dim)).astype(np.float32)
    meas = rng.uniform(0, 1, (b, cfg.n_measurements)).astype(np.float32)
    goal = rng.dirichlet(np.ones(cfg.n_measurements), b).astype(np.float32)
    valid = np.zeros((b, cfg.n_actions), np.float32)
    for i, n in enumerate(rng.integers(1, cfg.n_actions + 1, b)):
        valid[i, :n] = 1.0
    return state, meas, goal, valid


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("b", [1, 5, 16])
def test_forward_matches_reference(backend, b):
    ja, ta = agent_pair(RES, seed=3)
    ta.set_backend(backend)
    state, meas, goal, valid = _inputs(ja.dfp, b, seed=b)
    jx = [jnp.asarray(a) for a in (state, meas, goal)]
    tx = [torch.from_numpy(a) for a in (state, meas, goal)]
    np.testing.assert_allclose(
        tdfp.predict(ta.net, ta.dfp, *tx).numpy(),
        np.asarray(jdfp.predict(ja.params, ja.dfp, *jx)), **TOL)
    ju = np.asarray(jdfp.action_values(ja.params, ja.dfp, *jx))
    tu = tdfp.action_values(ta.net, ta.dfp, *tx).numpy()
    np.testing.assert_allclose(tu, ju, **TOL)
    # Greedy selection: the same argmax wherever the top two valid values
    # are further apart than the tolerance.
    packed = np.concatenate([state, meas, goal, valid], axis=1)
    ja_act = np.asarray(jdfp.greedy_actions_packed(ja.params, ja.dfp,
                                                   jnp.asarray(packed)))
    ta_act = tdfp.greedy_actions_packed(ta.net, ta.dfp,
                                        torch.from_numpy(packed)).numpy()
    masked = np.where(valid > 0.5, ju, -np.inf)
    top2 = np.sort(masked, axis=1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 2e-4 * max(1.0, np.abs(ju).max())
    assert decisive.sum() >= b // 2 + 1
    assert (ta_act[decisive] == ja_act[decisive]).all()
    assert ((valid[np.arange(b), ta_act]) == 1.0).all()     # never invalid
    # greedy_action (one decision) agrees with the packed path.
    for i in range(b):
        a = tdfp.greedy_action(ta.net, ta.dfp, *(t[i] for t in tx),
                               torch.from_numpy(valid[i] > 0.5))
        assert int(a) == int(ta_act[i])


def test_argmax_ties_take_the_first_slot():
    ja, ta = agent_pair(RES)
    packed = np.zeros((2, ta.enc.state_dim + 4 + 10), np.float32)
    packed[:, ta.enc.state_dim + 4:] = 1.0
    with torch.no_grad():            # equal action streams: all slots tie
        for p in ta.net.action.parameters():
            p.zero_()
    u = tdfp.action_values(ta.net, ta.dfp, torch.zeros(1, ta.enc.state_dim),
                           torch.zeros(1, 2), torch.full((1, 2), 0.5))
    assert torch.unique(u).numel() == 1
    assert tdfp.greedy_actions_packed(
        ta.net, ta.dfp, torch.from_numpy(packed)).tolist() == [0, 0]


def test_param_names_follow_the_jax_tree():
    ja, ta = agent_pair(RES)
    import jax
    flat = jax.tree_util.tree_flatten(ja.params)[0]
    ours = leaves(ta.net)
    assert len(ours) == len(flat)
    for (name, p), ref in zip(ours, flat):
        assert tuple(p.shape) == tuple(ref.shape), name
        assert np.array_equal(p.detach().numpy(), np.asarray(ref)), name
    assert set(params_from_jax(jax_tree_numpy(ja.params))) == \
        set(ta.net.state_dict())


def test_npz_reference_to_port(tmp_path):
    ja, _ = agent_pair(RES, seed=1)
    _, ta = agent_pair(RES, seed=2)
    ja.epsilon = 0.25
    ja.save(str(tmp_path / "ref.npz"))
    ta.load(str(tmp_path / "ref.npz"))
    import jax
    for (name, p), ref in zip(leaves(ta.net),
                              jax.tree_util.tree_flatten(ja.params)[0]):
        assert np.array_equal(p.detach().numpy(), np.asarray(ref)), name
    assert ta.epsilon == 0.25


def test_npz_port_to_reference(tmp_path):
    ja, ta = agent_pair(RES, seed=1)
    with torch.no_grad():
        for _, p in leaves(ta.net):
            p.add_(0.5)                         # differ from the JAX agent
    ta.save(str(tmp_path / "port.npz"))
    ja.load(str(tmp_path / "port.npz"))
    import jax
    for (name, p), ref in zip(leaves(ta.net),
                              jax.tree_util.tree_flatten(ja.params)[0]):
        assert np.array_equal(p.detach().numpy(), np.asarray(ref)), name


def test_npz_shape_mismatch_raises(tmp_path):
    ja, _ = agent_pair(RES, state_hidden=(16, 8))
    _, ta = agent_pair(RES)
    ja.save(str(tmp_path / "wrong.npz"))
    with pytest.raises(ValueError, match="shape mismatch"):
        ta.load(str(tmp_path / "wrong.npz"))
    wrong = agent_pair(RES, module_hidden=8)[1]
    ta.save(str(tmp_path / "port.npz"))
    with pytest.raises(ValueError, match="shape mismatch"):
        wrong.load(str(tmp_path / "port.npz"))


def test_agent_requires_a_card_unless_cpu_is_asked():
    from repro_torch.core import MRSchAgent
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MRSchAgent([PKGS["torch"].ResourceSpec("node", 4)])
