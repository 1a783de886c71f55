"""The port's LM training pieces against the JAX package's: the learning-
rate schedules, AdamW (``repro_torch.optim``: every combination of the
factored second moment, the first moment's dtype, weight decay and an
active clip), the stacked layout both ways (``convert.lm_params_to_tree``,
``load_lm_tree``), MoE's gradient with dropped choices, and serving on
parameters that train (no graph); ``make_train_step`` itself is held in
test_torch_lm_train_loop.py.  Inputs come from numpy with a seed or from both
packages' ``make_batch``; weights from the reference, converted; float32
parameters.  The reference's calls are jitted; each tolerance is stated
where it is used."""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import batches, dtypes, flat, reference
from repro import configs as jconfigs
from repro import optim as joptim
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.convert import (_unstacked, lm_params_to_tree,
                                 load_lm_tree, params_from_jax)
from repro_torch.launch import make_prefill_step, make_train_step
from repro_torch.launch.serve import generate
from repro_torch.models import init_params, moe
from repro_torch.optim import OptConfig, make_schedule, opt_init, opt_update

# Sums of a few hundred float32 products in another order.
TOL = dict(rtol=2e-5, atol=2e-5)
# The reference tests' own gradient tolerances (tests/test_kernels.py:15).
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
M_DTYPES = {"float32": (jnp.float32, torch.float32),
            "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --------------------------------------------------------------- schedule
@pytest.mark.parametrize("kind", ["cosine", "constant", "rsqrt"])
def test_schedule_matches_reference(kind):
    """Steps 0..40 (warmup 5, total 30, so past the end too), as a vector
    and one step at a time from an int32 0-d tensor, as the optimizer's
    step is read: rtol 1e-6; the first step's rate is 0."""
    args = (kind, 1e-3, 5, 30, 0.1)
    want = np.asarray(jax.jit(jax.vmap(joptim.make_schedule(*args)))(
        jnp.arange(41)))
    sched = make_schedule(*args)
    got = sched(torch.arange(41))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    one = [float(sched(torch.tensor(s, dtype=torch.int32)))
           for s in range(41)]
    np.testing.assert_allclose(one, want, rtol=1e-6, atol=0)
    assert float(sched(0)) == 0.0 == want[0]


# ------------------------------------------------------------------ AdamW
def _grads(tree, seed: int):
    """Random gradients shaped as ``tree``, their magnitudes spread over
    five decades (from ~1e-5, near eps's scale once clipped, to ~1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 10.0 **
                                   rng.uniform(-5, 0, p.shape)).astype(
                                       np.float32), tree)


@functools.lru_cache(maxsize=None)
def _jit_opt_update(factored: bool, m_dtype: str, weight_decay: float):
    """The reference's update, jitted once per static configuration; the
    clip and the rate are traced arguments."""
    base = joptim.OptConfig(factored=factored, weight_decay=weight_decay,
                            m_dtype=M_DTYPES[m_dtype][0])

    def update(g, s, p, clip, lr):
        return joptim.opt_update(g, s, p, replace(base, grad_clip=clip),
                                 lr=lr)
    return base, jax.jit(update)


def _port_grads(g_tree) -> dict:
    return {n: _t(a) for n, a in _unstacked(flat(g_tree)).items()}


def _assert_state_equal_in_layout(state, jstate):
    """Paths, shapes and dtypes of the port's state equal the reference's."""
    got, want = flat(state), flat(jstate)
    assert got.keys() == want.keys()
    assert {k: v.shape for k, v in got.items()} \
        == {k: v.shape for k, v in want.items()}
    assert dtypes(state) == dtypes(jstate)


@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1], ids=["wd0", "wd"])
@pytest.mark.parametrize("m_dtype", list(M_DTYPES))
@pytest.mark.parametrize("factored", [False, True],
                         ids=["full_v", "factored"])
def test_adamw_matches_reference(factored, m_dtype, weight_decay, clip):
    """Three steps of ``opt_update`` at lr 1e-2 on deepseek-v2-lite's smoke
    tree (a one-layer stacked prefix, three MoE layers, the float32
    router), the same random gradients in both: the state's paths, shapes
    and dtypes are the reference's; the norm and every state leaf within
    rtol 1e-5.  The norm's float32 sum differs by a few 1e-6 between the
    packages (the reference's is 3.6e-6 from the exact one here), so a
    clipped gradient differs by as much, and a first-moment element that
    cancels over the steps differs by as much of its leaf's largest: each
    leaf also has an atol of 1e-5 of its largest element.  A bfloat16
    first moment is held to four of its ulps (2 ** -5 relative) and to
    one ulp of its leaf's largest (2 ** -7 of it): its float32 value may
    round the other way, and a flipped ulp carries into the next step's
    value, where it may flip another or cancel against the new gradient;
    it reaches the update too, so the parameters are held within rtol
    1e-5 and atol 1e-7, or lr / 16 with a bfloat16 first moment.  The
    update reads m in float32, before its rounding to ``m_dtype``, so
    after the first step, where no flip has carried yet, the parameters
    are held within rtol 1e-5 and atol 1e-7 whatever m's dtype (the
    largest error there is 1.7e-8 in both dtypes; an update that read the
    rounded bfloat16 m would be off by 3.9e-5 or more).  The clip is
    active at 1.0 (the norm is ~20) and not at 1e6.  Factored, the stacked (3, 64) norm scales are
    factored across the layers and the prefix's (1, 64) are not, as in
    the reference."""
    jcfg, cfg, tree, lm = reference("deepseek-v2-lite-16b")
    base, jupdate = _jit_opt_update(factored, m_dtype, weight_decay)
    ocfg = OptConfig(factored=factored, weight_decay=weight_decay,
                     grad_clip=clip, m_dtype=M_DTYPES[m_dtype][1])
    jstate, state = joptim.opt_init(tree, base), opt_init(lm, ocfg)
    _assert_state_equal_in_layout(state, jstate)
    leaves = flat(state)
    assert ("leaves.stack.norm1.scale.vr" in leaves) == factored
    assert "leaves.prefix.norm1.scale.v" in leaves
    lr = 1e-2
    for step in range(3):
        g = _grads(tree, step)
        tree, jstate, jnorm = jupdate(g, jstate, tree, clip, lr)
        state, gnorm = opt_update(_port_grads(g), state, lm, ocfg, lr=lr)
        np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-5)
        assert (float(jnorm) > clip) == (clip == 1.0)
        if step == 0:
            _assert_params_close(lm, tree, atol=1e-7)
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32
    _assert_state_close(state, jstate, lm, tree, m_dtype, lr)


def _assert_state_close(state, jstate, lm, tree, m_dtype, lr):
    """The state's layout and values and the parameters, held as
    ``test_adamw_matches_reference`` says."""
    _assert_state_equal_in_layout(state, jstate)
    got, want = flat(state), flat(jstate)
    bf16 = m_dtype == "bfloat16"
    for path in want:
        rtol, atol = (2 ** -5, 2 ** -7) if path.endswith(".m") and bf16 \
            else (1e-5, 1e-5)
        np.testing.assert_allclose(
            got[path], want[path], rtol=rtol,
            atol=atol * float(np.abs(want[path]).max()), err_msg=path)
    _assert_params_close(lm, tree, atol=lr / 16 if bf16 else 1e-7)


def _assert_params_close(lm, tree, atol):
    got, want = flat(lm_params_to_tree(lm)), flat(tree)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5,
                                   atol=atol, err_msg=path)


def test_adamw_factored_on_the_hybrid_tree():
    """zamba2-7b's smoke tree (Mamba2's float32 ``A_log`` and ``D`` and its
    (L, H) leaves factored across the layers, the conv (L, 4, C) within
    each, the shared blocks a list), factored with a bfloat16 first
    moment: two steps, held as ``test_adamw_matches_reference`` holds
    them."""
    jcfg, cfg, tree, lm = reference("zamba2-7b")
    base, jupdate = _jit_opt_update(True, "bfloat16", 0.1)
    ocfg = OptConfig(factored=True, m_dtype=torch.bfloat16)
    jstate, state = joptim.opt_init(tree, base), opt_init(lm, ocfg)
    for step in range(2):
        g = _grads(tree, 10 + step)
        tree, jstate, jnorm = jupdate(g, jstate, tree, 1.0, 1e-2)
        state, gnorm = opt_update(_port_grads(g), state, lm, ocfg, lr=1e-2)
        np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=1e-5)
        if step == 0:
            _assert_params_close(lm, tree, atol=1e-7)
    leaves = flat(state)
    assert "leaves.stack.ssm.A_log.vr" in leaves
    assert "leaves.shared_blocks.1.attn.wq.vc" in leaves
    _assert_state_close(state, jstate, lm, tree, "bfloat16", 1e-2)


# ---------------------------------------------------------- stacked layout
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-7b",
                                  "gemma-2b"])
def test_stacked_layout_both_ways(arch):
    """``lm_params_to_tree`` gives the reference's tree bit for bit (paths,
    shapes, values; the MoE prefix and the hybrid's list of shared blocks
    included), and ``load_lm_tree`` puts such a tree back into an ``LM``;
    a leaf of another shape is refused."""
    jcfg, cfg, tree, lm = reference(arch)
    got, want = flat(lm_params_to_tree(lm)), flat(tree)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    other = init_params(cfg, device="cpu", dtype=torch.float32)
    load_lm_tree(other, lm_params_to_tree(lm))
    for (n, p), (_, q) in zip(lm.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(p, q), n
    bad = lm_params_to_tree(lm)
    bad["final_norm"]["scale"] = bad["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm.scale"):
        load_lm_tree(other, bad)


# -------------------------------------------------------------------- MoE
@pytest.mark.parametrize("n_shared", [2, 0], ids=["shared", "routed_only"])
def test_moe_gradient_with_dropped_choices(n_shared):
    """B = 2 x S = 48 tokens over 8 experts, top 2, at capacity factor
    1.25, leaning one way so choices are dropped (asserted): the gradient
    of a weighted sum of ``moe_apply``'s output with respect to the tokens
    and every parameter within the reference's gradient tolerance.  A
    dropped choice lands in the spare row that the buffer's experts never
    read, so it gets a zero gradient, as the reference's dropped scatter
    gives; routed only, a token whose two choices were both dropped gets
    none at all."""
    jcfg = jconfigs.MoEConfig(n_routed=8, n_shared=n_shared, top_k=2,
                              d_expert=16)
    cfg = configs.MoEConfig(**vars(jcfg))
    D, B, S = 32, 2, 48
    tree = jmoe.moe_init(jax.random.PRNGKey(3), D, jcfg, True, jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B * S, D)).astype(np.float32)
    x += 1.5 * rng.standard_normal(D).astype(np.float32)
    w = rng.standard_normal((B, S, D)).astype(np.float32)
    _, jidx = jmoe.route(tree["router"], jnp.asarray(x), jcfg)
    C = jmoe._default_capacity(B * S, jcfg)
    kept = np.asarray(jmoe._positions_in_expert(jidx, 8)) < C
    assert not kept.all(), "no choice went past the capacity"

    def jloss(p, a):
        return jnp.sum(jmoe.moe_apply(p, a, jcfg, "silu", True)
                       * jnp.asarray(w))
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        tree, jnp.asarray(x).reshape(B, S, D))
    params = moe.MoE(D, cfg, True, torch.float32)
    params.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    params.requires_grad_(True)
    xt = _t(x).reshape(B, S, D).requires_grad_(True)
    (moe.moe_apply(params, xt, cfg, "silu", True) * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    want = flat(jgp)
    for n, p in params.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], err_msg=n,
                                   **GRAD_TOL)
    if not n_shared:
        # The router's gradient reaches x only through a kept choice.
        lost = ~kept.any(axis=1)
        assert lost.any(), "no token lost both choices"
        gx = xt.grad.reshape(B * S, D)[torch.from_numpy(lost)]
        assert torch.count_nonzero(gx) == 0


# ---------------------------------------------------------------- serving
def test_serving_builds_no_graph_on_parameters_that_train():
    """After a train step the parameters require grad; the prefill step
    (both backends) and ``generate`` still return tensors outside any
    graph."""
    cfg = configs.smoke_config("stablelm-1.6b")
    jcfg = jconfigs.smoke_config("stablelm-1.6b")
    lm = init_params(cfg, device="cpu", dtype=torch.float32)
    opt = OptConfig()
    lm, _, _ = make_train_step(cfg, opt)(lm, opt_init(lm, opt),
                                         batches(jcfg, cfg, seq=16)[1])
    assert all(p.requires_grad for p in lm.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(0))
    for backend in ("kernel", "torch"):
        out = make_prefill_step(cfg, backend)(lm, {"tokens": prompts})
        assert out.grad_fn is None and not out.requires_grad
    gen = generate(cfg, lm, prompts, max_new_tokens=3)
    assert gen["tokens"].grad_fn is None
    assert gen["tokens"].shape == (2, 11)


def test_parameters_stay_frozen_as_made():
    """``init_params`` and the conversion make parameters that take no
    gradient; only the training entry points turn them on."""
    cfg = configs.smoke_config("gemma-2b")
    lm = init_params(cfg, device="cpu", dtype=torch.float32)
    conv = reference("gemma-2b")[3]
    assert not any(p.requires_grad for p in lm.parameters())
    assert not any(p.requires_grad for p in conv.parameters())
