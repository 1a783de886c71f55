"""The port's window pack (``repro_torch.kernels.window_pack``) on the CPU
against the JAX package's Pallas kernel in interpret mode and its plain
reference: the same inputs, made with numpy from a seed, give exactly the
same packed window.  The device round's front (``pack_decision_rows``)
against the reference's own helpers on random round states."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _decision_rows import assert_same_front, decision_state, front_spec
from repro.kernels.window_pack.ops import pack_window as jax_pack_window
from repro.sim import device as jdev
from repro.sim.lifecycle import device_queued
from repro_torch.kernels.window_pack import (DecisionRowSpec,
                                             pack_decision_rows,
                                             pack_decision_rows_reference,
                                             pack_window,
                                             pack_window_reference)


def _inputs(n, j, f, density, seed, rows=()):
    rng = np.random.default_rng(seed)
    waiting = (rng.uniform(size=(n, j)) < density).astype(np.float32)
    for i, fill in rows:                  # whole rows set to 0 or 1
        waiting[i] = fill
    feats = rng.standard_normal((n, j, f)).astype(np.float32)
    return waiting, feats


def _loop_oracle(waiting, feats, window):
    """Slot w holds the (w+1)-th waiting job in index order."""
    n, _, f = feats.shape
    wf = np.zeros((n, window, f), np.float32)
    wi = np.zeros((n, window), np.int32)
    wv = np.zeros((n, window), bool)
    for i in range(n):
        for w, j in enumerate(np.flatnonzero(waiting[i] > 0.5)[:window]):
            wf[i, w], wi[i, w], wv[i, w] = feats[i, j], j, True
    return wf, wi, wv


# J = 1, W > J, all-zero and all-one rows, ragged J and F, wide W.
CASES = [
    (1, 1, 4, 10, 1.0, ()),
    (2, 1, 3, 4, 0.5, ((0, 0.0),)),
    (3, 50, 7, 10, 0.4, ((1, 0.0), (2, 1.0))),
    (4, 7, 4, 12, 0.6, ((3, 1.0),)),
    (5, 130, 4, 10, 0.05, ()),
    (2, 33, 5, 64, 0.9, ((0, 1.0),)),
    (6, 300, 4, 10, 0.0, ()),
    (1, 257, 2, 1, 0.3, ()),
]


@pytest.mark.parametrize("n,j,f,w,density,rows", CASES)
def test_pack_window_matches_pallas_interpret_and_reference(n, j, f, w,
                                                            density, rows):
    waiting, feats = _inputs(n, j, f, density, seed=n * 31 + j, rows=rows)
    launches = pack_window.launches
    out = [t.numpy() for t in pack_window(torch.from_numpy(waiting),
                                          torch.from_numpy(feats), window=w)]
    assert pack_window.launches == launches       # the CPU path counts none
    pallas = jax_pack_window(waiting, feats, window=w, use_pallas=True,
                             interpret=True)
    ref = jax_pack_window(waiting, feats, window=w, use_pallas=False)
    for theirs in (pallas, ref, _loop_oracle(waiting, feats, w)):
        for mine, other in zip(out, theirs):
            other = np.asarray(other)
            assert mine.dtype == other.dtype and mine.shape == other.shape
            np.testing.assert_array_equal(mine, other)


def test_reference_is_the_cpu_path():
    waiting, feats = _inputs(3, 20, 4, 0.5, seed=0)
    a = pack_window(torch.from_numpy(waiting), torch.from_numpy(feats),
                    window=6)
    b = pack_window_reference(torch.from_numpy(waiting),
                              torch.from_numpy(feats), window=6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[1].dtype == torch.int32 and a[2].dtype == torch.bool


def test_pack_window_rejects_bad_operands():
    waiting = torch.ones(2, 8)
    feats = torch.ones(2, 8, 4)
    with pytest.raises(TypeError, match="float32"):
        pack_window(waiting.double(), feats, window=4)
    with pytest.raises(ValueError, match="expected waiting"):
        pack_window(waiting, torch.ones(2, 9, 4), window=4)
    with pytest.raises(ValueError, match="empty"):
        pack_window(waiting, feats, window=0)
    with pytest.raises(ValueError, match="contiguous"):
        pack_window(waiting, feats.transpose(0, 1).contiguous()
                    .transpose(0, 1), window=4)


# ------------------------------------------------------ the round's front
# (mode, N, J, caps, enc_caps, W, K, density, drains): MLP rows with the
# encoding's sections above (node) and below (bb) the capacity, with and
# without drains; attention at Q > J and Q < the waiting count; the mask
# rows; no job waiting; more waiting than K.
FRONT_CASES = [
    ("mlp", 3, 40, (16, 8), (16, 8), 10, 10, 0.4, False),
    ("mlp", 4, 50, (16, 8), (20, 6), 4, 4, 0.6, True),
    ("mlp", 2, 30, (16, 8), (12, 10), 10, 10, 0.0, True),
    ("attention", 3, 8, (16, 8), (16, 8), 4, 12, 0.5, False),
    ("attention", 4, 60, (16, 8), (16, 8), 4, 12, 0.7, True),
    ("attention", 2, 20, (16, 8, 5), (16, 8, 5), 4, 12, 0.0, False),
    ("mask", 3, 50, (16, 8), (16, 8), 10, 10, 0.4, True),
    ("mask", 2, 33, (7,), (7,), 5, 5, 1.0, False),
]


def _jax_front(mode, caps, enc_caps, w, k, drains, time_scale, state,
               use_pallas=False):
    """The reference's decide, lines 588-610, from its own helpers."""
    n, j = state["ready"].shape
    layout = jdev.DeviceLayout(
        names=tuple(f"r{r}" for r in range(len(caps))), caps=tuple(caps),
        enc_caps=tuple(enc_caps), window=w, n_envs=n, n_jobs=j, rounds=1,
        backfill=True, requires_obs=mode != "mask", time_scale=time_scale,
        state_module="attention" if mode == "attention" else "mlp",
        queue_cap=k if mode == "attention" else 0)
    st = {name: jnp.asarray(v) for name, v in state.items()
          if v is not None}
    waiting = device_queued(st["ready"], st["now"], st["started"],
                            st["finished"], st["failed"]).astype(jnp.float32)
    free = jdev._segment_free(layout, st["release"])
    pk_feats, pk_idx, pk_valid = jax_pack_window(
        waiting, st["feats"], window=k, use_pallas=use_pallas,
        interpret=True)
    if mode == "mask":
        obs = pk_valid[:, :w].astype(jnp.float32)
    else:
        meas, goal = jdev._meas_goal(layout, st, st, free, waiting, drains)
        if mode == "attention":
            obs = jdev._build_obs_attention(layout, st, st, waiting,
                                            pk_feats, pk_valid, meas, goal)
        else:
            obs = jdev._build_obs(layout, st, st, pk_feats, pk_valid, meas,
                                  goal)
    return [np.asarray(x) for x in (waiting, waiting.sum(axis=1), free,
                                    pk_idx, pk_valid, obs)]


def _torch_front(spec, state):
    return pack_decision_rows(spec, **{
        name: None if v is None else torch.from_numpy(v)
        for name, v in state.items()})


@pytest.mark.parametrize("mode,n,j,caps,enc_caps,w,k,density,drains",
                         FRONT_CASES)
def test_decision_rows_match_the_reference_helpers(mode, n, j, caps,
                                                   enc_caps, w, k, density,
                                                   drains):
    """pack_decision_rows on the CPU (the composite) equals the
    reference's device_queued, _segment_free, pack_window, _meas_goal and
    _build_obs / _build_obs_attention on the same state: bit for bit but
    in the summed columns (goal, attention mean TTF), where torch's and
    XLA's CPU sums differ in order (1 ulp seen)."""
    ts = 3600.0 if mode == "attention" else 86400.0
    state = decision_state(n, j, caps, density, drains=drains,
                           seed=n * 97 + j, time_scale=ts)
    spec = front_spec(mode, caps, enc_caps, w, k, drains, ts)
    launches = pack_decision_rows.launches
    out = _torch_front(spec, state)
    assert pack_decision_rows.launches == launches   # the CPU counts none
    ref = _jax_front(mode, caps, enc_caps, w, k, drains, ts, state)
    assert out.obs.shape == (n, spec.row_dim)
    assert_same_front(spec, [t.numpy() for t in out], ref)
    n_wait = out.n_waiting.numpy()
    assert (n_wait == out.waiting.numpy().sum(axis=1)).all()
    if density == 0.0:
        assert not out.valid.any()
    elif density < 1.0:
        assert n_wait[0] == 3


def test_decision_rows_match_the_pallas_kernel_in_interpret_mode():
    """One MLP case with the pack taken by the Pallas kernel itself."""
    mode, n, j, caps, enc_caps, w, k, density, drains = FRONT_CASES[1]
    state = decision_state(n, j, caps, density, drains=drains, seed=5)
    spec = front_spec(mode, caps, enc_caps, w, k, drains, 86400.0)
    out = _torch_front(spec, state)
    ref = _jax_front(mode, caps, enc_caps, w, k, drains, 86400.0, state,
                     use_pallas=True)
    assert_same_front(spec, [t.numpy() for t in out], ref)


def test_decision_rows_reference_is_the_cpu_path_with_fresh_outputs():
    from repro_torch.kernels.window_pack.ref import (PHANTOM_OWNER,
                                                     TTF_HORIZON)
    from repro_torch.sim.cluster import TTF_HORIZON as SIM_HORIZON
    from repro_torch.sim.lifecycle import PHANTOM_OWNER as SIM_PHANTOM
    assert (TTF_HORIZON, PHANTOM_OWNER) == (SIM_HORIZON, SIM_PHANTOM)
    state = decision_state(2, 20, (16, 8), 0.5, drains=True, seed=1)
    spec = front_spec("mlp", (16, 8), (16, 8), 10, 10, True, 86400.0)
    a = _torch_front(spec, state)
    b = pack_decision_rows_reference(spec, **{
        name: torch.from_numpy(v) for name, v in state.items()})
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = _torch_front(spec, state)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a, c))
    assert a.idx.dtype == torch.int32 and a.valid.dtype == torch.bool


def test_pack_decision_rows_rejects_bad_operands():
    state = {name: None if v is None else torch.from_numpy(v)
             for name, v in decision_state(2, 20, (16, 8), 0.5).items()}
    spec = front_spec("mlp", (16, 8), (16, 8), 10, 10, False, 86400.0)
    cases = [
        ({"ready": state["ready"].double()}, TypeError, "ready must be"),
        ({"started": state["started"].float()}, TypeError, "started"),
        ({"release": state["release"][:, :-1]}, ValueError, "shape"),
        ({"feats": state["feats"].transpose(0, 1).contiguous()
          .transpose(0, 1)}, ValueError, "contiguous"),
        ({"owner": torch.zeros(2, 24, dtype=torch.int32)}, ValueError,
         "drains"),
    ]
    for change, exc, match in cases:
        with pytest.raises(exc, match=match):
            pack_decision_rows(spec, **{**state, **change})
    with pytest.raises(ValueError, match="window <= k"):
        DecisionRowSpec(mode="attention", window=10, k=4,
                        segments=((0, 16),), enc_caps=(16,),
                        time_scale=1.0, has_drains=False)
    with pytest.raises(ValueError, match="mode"):
        DecisionRowSpec(mode="dense", window=4, k=4, segments=((0, 16),),
                        enc_caps=(16,), time_scale=1.0, has_drains=False)


def test_row_params_mirror_the_source_and_carry_the_simulator_constants():
    """The ctypes ``RowParams`` lists the source's fields in its order, and
    the kernel gets the horizon and the phantom owner from ``ref``, the
    values the simulator uses: the source holds no copy of either."""
    import re

    from repro_torch.kernels.window_pack import kernel
    from repro_torch.kernels.window_pack.ref import (PHANTOM_OWNER,
                                                     TTF_HORIZON)
    src = kernel.SOURCE.read_text()
    body = re.search(r"struct RowParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if decl.strip():
            names += [re.sub(r"\[.*\]", "", n).strip()
                      for n in decl.split(None, 1)[1].split(",")]
    assert names == [name for name, _ in kernel.RowParams._fields_]
    assert "2592000" not in src and "-2;" not in src
    spec = front_spec("mlp", (16, 8), (16, 8), 10, 10, True, 86400.0)
    p = kernel.row_params(spec, 2, 20)
    assert p.phantom_owner == PHANTOM_OWNER
    assert p.ttf_horizon == np.float32(TTF_HORIZON)
