"""The port's MoE (``repro_torch.models.moe``) and the DeepSeek stacks it
joins, against the JAX package's: routing, the in-expert positions that
decide which choices are dropped, ``moe_apply`` with and without GLU and
shared experts at the default capacity factor 1.25 with choices dropped,
the load-balance loss, whole-model logits of both DeepSeek smoke configs
on both backends, and the bfloat16 parameter trees of both DeepSeek
configs leaf by leaf, dtypes included.  Inputs come from numpy with a
seed; weights from the reference, converted.  float32 unless said;
each tolerance is stated where it is used.

Ties in top-k: ``jax.lax.top_k`` puts the lower index first, while
``torch.topk`` promises no order among equal values.  With float32 router
probabilities ties are measure-zero; every routing test asserts that no
two of a row's probabilities lie within 1e-6 of each other."""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.launch import make_prefill_step
from repro_torch.models import moe, transformer

# Sums of a few hundred float32 products in another order.
TOL = dict(rtol=2e-5, atol=2e-5)
# A whole model: layers compound the order differences (as in
# tests/test_torch_models.py).
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
DEEPSEEK = ("deepseek-v2-lite-16b", "deepseek-v3-671b")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _assert_no_ties(x, router):
    """No two of a row's router probabilities within 1e-6 (see above)."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router),
                                      axis=-1))
    gaps = np.diff(np.sort(probs, axis=-1), axis=-1)
    assert gaps.min() > 1e-6, gaps.min()


def _moe_case(seed, D, cfg, glu, T, skew=0.0):
    """The reference's MoE parameters and tokens (T, D); ``skew`` adds a
    shared direction to every token so the router favours a few experts
    and they overflow."""
    tree = jmoe.moe_init(jax.random.PRNGKey(seed), D, cfg, glu, jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    x += skew * rng.standard_normal(D).astype(np.float32)
    _assert_no_ties(x, tree["router"])
    params = moe.MoE(D, configs.MoEConfig(**vars(cfg)), glu, torch.float32)
    params.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)),
                           strict=True)
    return tree, params, x


@pytest.mark.parametrize("T,K", [(37, 2), (64, 6), (5, 1)])
def test_route(T, K):
    cfg = jconfigs.MoEConfig(n_routed=16, n_shared=0, top_k=K, d_expert=8)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((T, 24)).astype(np.float32)
    router = rng.standard_normal((24, 16)).astype(np.float32) / 4
    _assert_no_ties(x, router)
    gates, idx = moe.route(_t(router), _t(x),
                           configs.MoEConfig(**vars(cfg)))
    jgates, jidx = jmoe.route(jnp.asarray(router), jnp.asarray(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **TOL)
    assert gates.dtype == torch.float32


@pytest.mark.parametrize("T,K,E", [(40, 2, 4), (100, 6, 8), (7, 3, 64),
                                   (1, 1, 2)])
def test_positions_in_expert(T, K, E):
    """Many collisions: ``T * K`` choices over ``E`` experts, drawn with
    repeats inside a row too; positions must equal the reference's
    exactly, since they decide which choices are dropped."""
    idx = np.random.default_rng(T + E).integers(0, E, (T, K))
    got = moe._positions_in_expert(torch.from_numpy(idx), E)
    want = jmoe._positions_in_expert(jnp.asarray(idx, jnp.int32), E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_capacity():
    cfg = jconfigs.MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=8)
    for T in (1, 2, 7, 96, 8192):
        for f in (1.25, 16.0):
            c = replace(cfg, capacity_factor=f)
            assert moe._default_capacity(T, configs.MoEConfig(**vars(c))) \
                == jmoe._default_capacity(T, c)
    assert jmoe._default_capacity(8192, cfg) == 960


@pytest.mark.parametrize("glu", [True, False], ids=["glu", "plain"])
@pytest.mark.parametrize("n_shared", [2, 0], ids=["shared", "routed_only"])
def test_moe_apply_drops_the_references_choices(glu, n_shared):
    """B = 2 x S = 48 tokens over 8 experts, top 2, at the default
    capacity factor 1.25 (C = 30): the tokens lean one way so some experts
    overflow, and the test asserts choices were dropped; the output
    (dropped choices give 0) within 2e-5 of the reference's."""
    cfg = jconfigs.MoEConfig(n_routed=8, n_shared=n_shared, top_k=2,
                             d_expert=16)
    D, B, S = 32, 2, 48
    tree, params, x = _moe_case(3, D, cfg, glu, B * S, skew=1.5)
    _, jidx = jmoe.route(tree["router"], jnp.asarray(x), cfg)
    C = jmoe._default_capacity(B * S, cfg)
    dropped = int((np.asarray(jmoe._positions_in_expert(jidx, 8)) >= C).sum())
    assert dropped > 0, "no choice went past the capacity"
    act = "silu" if glu else "relu2"
    got = moe.moe_apply(params, _t(x).reshape(B, S, D),
                        configs.MoEConfig(**vars(cfg)), act, glu)
    want = jax.jit(lambda p, a: jmoe.moe_apply(p, a, cfg, act, glu))(
        tree, jnp.asarray(x).reshape(B, S, D))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_apply_dropless_equals_the_dense_mixture():
    """At capacity factor 16 nothing is dropped, and the routed part is
    each token's gate-weighted sum of its experts' FFNs, computed here one
    token at a time (an oracle independent of both packages' buffers)."""
    cfg = jconfigs.MoEConfig(n_routed=8, n_shared=0, top_k=3, d_expert=16,
                             capacity_factor=16.0)
    tree, params, x = _moe_case(4, 32, cfg, True, 20)
    tcfg = configs.MoEConfig(**vars(cfg))
    got = moe.moe_apply(params, _t(x)[None], tcfg, "silu", True)[0]
    gates, idx = moe.route(params.router, _t(x), tcfg)
    want = torch.zeros_like(got)
    for t in range(20):
        for j in range(3):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(_t(x)[t] @ params.w_gate[e]) \
                * (_t(x)[t] @ params.w_up[e])
            want[t] += gates[t, j] * (h @ params.w_down[e])
    torch.testing.assert_close(got, want, **TOL)


def test_load_balance_loss():
    cfg = jconfigs.MoEConfig(n_routed=8, n_shared=0, top_k=2, d_expert=8)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 20, 16)).astype(np.float32)
    router = rng.standard_normal((16, 8)).astype(np.float32) / 4
    _assert_no_ties(x.reshape(-1, 16), router)
    got = moe.load_balance_loss(_t(router), _t(x),
                                configs.MoEConfig(**vars(cfg)))
    want = jmoe.load_balance_loss(jnp.asarray(router), jnp.asarray(x), cfg)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_moe_init_matches_the_reference_tree():
    """``moe_init`` makes the reference's leaves (router float32 in a
    bfloat16 module) with its scale of draws."""
    cfg = jconfigs.MoEConfig(n_routed=8, n_shared=2, top_k=2, d_expert=64)
    want = jax.eval_shape(lambda: jmoe.moe_init(jax.random.PRNGKey(0), 128,
                                                cfg, True, jnp.bfloat16))
    got = moe.moe_init(128, configs.MoEConfig(**vars(cfg)), True,
                       torch.bfloat16,
                       generator=torch.Generator().manual_seed(0))
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {n: (tuple(p.shape), str(p.dtype)[6:])
            for n, p in got.named_parameters()} == \
        {n: (tuple(s.shape), str(s.dtype)) for n, s in flat.items()}
    assert abs(float(got.w_up.float().std()) * 128 ** 0.5 - 1.0) < 0.05
    assert abs(float(got.router.std()) * 128 ** 0.5 - 1.0) < 0.1


# ------------------------------------------------------------ whole model
@functools.cache
def _deepseek(arch):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    tree = jtransformer.init_params(jax.random.PRNGKey(7), jcfg, jnp.float32)
    params = lm_params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 70))
    want = jax.jit(lambda p, b: jtransformer.forward(p, jcfg, b))(
        tree, {"tokens": jnp.asarray(tokens, jnp.int32)})
    return jcfg, cfg, params, torch.from_numpy(tokens), np.asarray(want)


@pytest.mark.parametrize("arch", DEEPSEEK)
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_forward_logits_of_deepseek_smoke_configs(arch, backend):
    """Whole-model logits (B = 2, S = 70: MLA's dense path, the dense
    prefix, MoE layers at capacity 1.25 with choices dropped) and the
    prefill step, held against the reference's (``MODEL_TOL``)."""
    jcfg, cfg, params, tokens, want = _deepseek(arch)
    got = transformer.forward(params, cfg, {"tokens": tokens},
                              backend=backend)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    last = make_prefill_step(cfg, backend)(params, {"tokens": tokens})
    np.testing.assert_allclose(last.numpy(), want[:, -1], **MODEL_TOL)


def _reference_leaves(jcfg):
    """The reference's bfloat16 tree for ``jcfg`` as shapes only, named
    as the port's leaves (stacked layers unstacked) -> {name: (shape,
    dtype)}."""
    shapes = jax.eval_shape(lambda: jtransformer.init_params(
        jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[0] in ("stack", "prefix"):
            for i in range(s.shape[0]):
                out[".".join([keys[0], str(i)] + keys[1:])] = (
                    tuple(s.shape[1:]), str(s.dtype))
        else:
            out[".".join(keys)] = (tuple(s.shape), str(s.dtype))
    return out


def _leaves(lm):
    return {n: (tuple(p.shape), str(p.dtype)[6:])
            for n, p in lm.named_parameters()}


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_deepseek_trees_keep_every_leaf_dtype(arch):
    """bfloat16: every leaf's name, shape and dtype equal to the
    reference's, the router float32.  The full config is compared through
    the port's module made on the meta device (no memory); the smoke
    config is converted from the reference (``lm_params_from_jax``,
    where ``load_state_dict`` would silently cast a float32 leaf into a
    bfloat16 parameter) and drawn by ``init_params``."""
    full = configs.get_config(arch)
    want = _reference_leaves(jconfigs.get_config(arch))
    got = _leaves(transformer.LM(full, torch.bfloat16, "meta"))
    assert got == want
    assert got["stack.0.moe.router"][1] == "float32"
    # ``param_count`` leaves out the norm scales: two a layer, MLA's
    # kv_norm (and q_norm with a q rank), and the final norm.
    m = full.mla
    norms = full.n_layers * (2 * full.d_model + m.kv_lora_rank
                             + (m.q_lora_rank or 0)) + full.d_model
    assert sum(int(np.prod(s)) for s, _ in got.values()) \
        == full.param_count()[0] + norms
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    tree = jtransformer.init_params(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    want = _reference_leaves(jcfg)
    converted = lm_params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                   device="cpu")
    drawn = transformer.init_params(cfg, device="cpu", dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(0))
    assert _leaves(converted) == want and _leaves(drawn) == want
    router = np.asarray(tree["stack"]["moe"]["router"][0])
    np.testing.assert_array_equal(
        converted.stack[0].moe.router.numpy(), router)
