"""The port's LM serving path against the JAX package's: MLA in both forms
(``mla_apply`` on both sides of a lowered dense threshold and on both
backends, ``mla_decode_apply`` step by step), ``decode_attention_apply``
and ``mamba2_decode_apply`` step by step, cache leaves included, one
``decode_step`` of every smoke architecture with every cache leaf, the
port's token-by-token decode against the reference's full forward, and
``generate``'s tokens against the reference's.  Inputs come from numpy
with a seed; weights from the reference, converted.  float32 throughout;
each tolerance is stated where it is used."""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.serve import generate as jgenerate
from repro.models import attention as jattn
from repro.models import mamba2 as jmamba2
from repro.models import mla as jmla
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.launch import make_decode_step
from repro_torch.launch import serve
from repro_torch.models import attention, mamba2, mla, transformer

# Sums of a few hundred float32 products in another order.
TOL = dict(rtol=2e-5, atol=2e-5)
# A whole model: layers compound the order differences (as in
# tests/test_torch_models.py).
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# Decode against the full forward: the reference's own tolerance
# (tests/test_models.py::test_decode_matches_forward).  MLA's absorbed
# decode and decompressed prefill sum the same products in other orders
# and groupings, so they agree only to rounding.
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
BACKENDS = ("kernel", "torch")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _module(cls, tree, *args):
    m = cls(*args, dtype=torch.float32)
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)),
                      strict=True)
    return m


def _mla_cfgs(q_lora):
    """deepseek-v2-lite's smoke MLA (q_lora None) or v3's (48)."""
    arch = "deepseek-v3-671b" if q_lora else "deepseek-v2-lite-16b"
    return (jconfigs.smoke_config(arch).mla, configs.smoke_config(arch).mla)


# -------------------------------------------------------------------- MLA
@pytest.mark.parametrize("q_lora", [None, 48], ids=["v2_lite", "v3"])
@pytest.mark.parametrize("threshold", [64, 16], ids=["dense", "flash"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_mla_apply(q_lora, threshold, backend):
    """S = 40 below the threshold (dense) and above it: B7's plain version
    with v zero-padded to q's 24 columns on the kernel backend,
    ``flash_attention_scan`` on the torch one; the reference runs its
    ``flash_attention_scan`` past the threshold."""
    jm, tm = _mla_cfgs(q_lora)
    D, H, S = 64, 4, 40
    tree = jmla.mla_init(jax.random.PRNGKey(1), D, H, jm, jnp.float32)
    params = _module(mla.MLA, tree, D, H, tm)
    x = np.random.default_rng(1).standard_normal((2, S, D)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).copy()
    got = mla.mla_apply(params, _t(x), torch.from_numpy(pos), n_heads=H,
                        mla=tm, dense_threshold=threshold, backend=backend)
    want = jax.jit(lambda p, a, b: jmla.mla_apply(
        p, a, b, n_heads=H, mla=jm, dense_threshold=threshold))(
        tree, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("q_lora", [None, 48], ids=["v2_lite", "v3"])
def test_mla_decode_apply_step_by_step(q_lora):
    """Six absorbed-form steps into a cache of 8: each step's output and
    both cache leaves (written in place here, returned anew there)."""
    jm, tm = _mla_cfgs(q_lora)
    D, H, B = 64, 4, 2
    tree = jmla.mla_init(jax.random.PRNGKey(2), D, H, jm, jnp.float32)
    params = _module(mla.MLA, tree, D, H, tm)
    xs = np.random.default_rng(2).standard_normal((6, B, 1, D)).astype(
        np.float32)
    jc = jnp.zeros((B, 8, jm.kv_lora_rank))
    jr = jnp.zeros((B, 8, jm.qk_rope_head_dim))
    tc, tr = torch.zeros(jc.shape), torch.zeros(jr.shape)
    step = jax.jit(lambda p, x, c, r, pos: jmla.mla_decode_apply(
        p, x, c, r, pos, n_heads=H, mla=jm))
    for pos in range(6):
        want, jc, jr = step(tree, jnp.asarray(xs[pos]), jc, jr, pos)
        got, c, r = mla.mla_decode_apply(params, _t(xs[pos]), tc, tr, pos,
                                         n_heads=H, mla=tm)
        assert c is tc and r is tr
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)


@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1)], ids=["gqa", "mqa"])
def test_decode_attention_apply_step_by_step(H, KV):
    """Five steps into a cache of 7, partial rotary: outputs and the k and
    v caches."""
    D, dh, B = 32, 16, 2
    tree = jattn.attention_init(jax.random.PRNGKey(3), D, H, KV, dh,
                                jnp.float32)
    params = _module(attention.Attention, tree, D, H, KV, dh)
    xs = np.random.default_rng(3).standard_normal((5, B, 1, D)).astype(
        np.float32)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=dh, rope_fraction=0.5)
    jk = jv = jnp.zeros((B, 7, KV, dh))
    tk, tv = torch.zeros(jk.shape), torch.zeros(jv.shape)
    step = jax.jit(lambda p, x, k, v, pos: jattn.decode_attention_apply(
        p, x, k, v, pos, **kw))
    for pos in range(5):
        want, jk, jv = step(tree, jnp.asarray(xs[pos]), jk, jv, pos)
        got, _, _ = attention.decode_attention_apply(params, _t(xs[pos]),
                                                     tk, tv, pos, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_mamba2_decode_apply_step_by_step():
    """Six recurrent steps with two groups and A_log drawn (decays other
    than 1): outputs, the float32 state and the conv window."""
    jcfg = jconfigs.SSMConfig(d_state=8, head_dim=16, n_groups=2)
    cfg = configs.SSMConfig(d_state=8, head_dim=16, n_groups=2)
    tree = jmamba2.mamba2_init(jax.random.PRNGKey(4), 32, jcfg, jnp.float32)
    tree = dict(tree, A_log=jnp.asarray(np.random.default_rng(4).uniform(
        -1, 1, tree["A_log"].shape), jnp.float32))
    params = _module(mamba2.Mamba2, tree, 32, cfg)
    us = np.random.default_rng(5).standard_normal((6, 2, 1, 32)).astype(
        np.float32)
    jcache = jmamba2.mamba2_decode_init_cache(2, 32, jcfg, jnp.float32)
    cache = mamba2.mamba2_decode_init_cache(2, 32, cfg, torch.float32)
    assert {k: tuple(t.shape) for k, t in cache.items()} == \
        {k: tuple(t.shape) for k, t in jcache.items()}
    assert cache["state"].dtype == torch.float32
    step = jax.jit(lambda p, u, c: jmamba2.mamba2_decode_apply(p, u, c, jcfg))
    for i in range(6):
        want, jcache = step(tree, jnp.asarray(us[i]), jcache)
        got, _ = mamba2.mamba2_decode_apply(params, _t(us[i]), cache, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("state", "conv"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)


# ------------------------------------------------------------ whole model
@functools.cache
def _model(arch, seed=0, dropless=False):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    if dropless and cfg.moe is not None:
        # Capacity dropping depends on the batch, so it would differ
        # between a step of B tokens and a forward of B * S: dropless, as
        # the reference's test_decode_matches_forward.
        jcfg = replace(jcfg, moe=replace(jcfg.moe, capacity_factor=16.0))
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=16.0))
    tree = jtransformer.init_params(jax.random.PRNGKey(seed), jcfg,
                                    jnp.float32)
    return jcfg, cfg, tree, lm_params_from_jax(
        jax.tree.map(np.asarray, tree), cfg, device="cpu")


def _cache_leaves(tree):
    """{path: leaf} of a cache tree (the port's dicts or the reference's
    pytree)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    return out


def _decode_input(cfg, B, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        e = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        return {"embeddings": jnp.asarray(e)}, {"embeddings": _t(e)}
    shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, 1)
    t = rng.integers(0, cfg.vocab_size, shape)
    return {"tokens": jnp.asarray(t, jnp.int32)}, {
        "tokens": torch.from_numpy(t)}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_decode_step_of_every_smoke_arch(arch):
    """Three steps of ``decode_step`` (B = 2, a cache of 16) from a cache
    that ``init_cache`` makes as the reference's: the logits and every
    cache leaf after each step; the decode step's last-position logits
    from ``make_decode_step``."""
    jcfg, cfg, tree, params = _model(arch, seed=5)
    jcache = jtransformer.init_cache(jcfg, 2, 16, jnp.float32)
    cache = transformer.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    want_leaves = _cache_leaves(jcache)
    assert {k: tuple(v.shape) for k, v in _cache_leaves(cache).items()} == \
        {k: tuple(v.shape) for k, v in want_leaves.items()}
    step = jax.jit(lambda p, b, c, pos: jtransformer.decode_step(
        p, jcfg, b, c, pos))
    serve_step = make_decode_step(cfg)
    for pos in range(3):
        jb, tb = _decode_input(cfg, 2, pos)
        want, jcache = step(tree, jb, jcache, pos)
        if pos < 2:
            got, same = transformer.decode_step(params, cfg, tb, cache, pos)
            assert got.shape == want.shape and got.dtype == torch.float32
        else:
            got, same = serve_step(params, tb, cache, pos)
            want = want[:, -1]
        assert same is cache
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        want_leaves = _cache_leaves(jcache)
        for name, leaf in _cache_leaves(cache).items():
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(want_leaves[name]),
                                       **MODEL_TOL, err_msg=name)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-1.3b",
                                  "deepseek-v2-lite-16b", "zamba2-7b"])
def test_decode_matches_the_reference_forward(arch):
    """The port's token-by-token decode (B = 1, S = 24, dropless MoE)
    reproduces the reference's full-sequence forward, at the reference's
    own decode tolerance (KV cache, MLA absorbed decode, SSM recurrence,
    the hybrid's shared KV slots)."""
    jcfg, cfg, tree, params = _model(arch, seed=1, dropless=True)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 24))
    want = jax.jit(lambda p, b: jtransformer.forward(p, jcfg, b))(
        tree, {"tokens": jnp.asarray(tokens, jnp.int32)})
    cache = transformer.init_cache(cfg, 1, 24, torch.float32, device="cpu")
    step = make_decode_step(cfg)
    outs = []
    for t in range(24):
        lg, cache = step(params, {"tokens": torch.from_numpy(
            tokens[:, t:t + 1])}, cache, t)
        outs.append(lg.numpy())
    np.testing.assert_allclose(np.stack(outs, axis=1), np.asarray(want),
                               **DECODE_TOL)


# The least top-2 margin of the reference's logits at a greedy step: far
# above DECODE_TOL, so either package's rounding cannot swap the choice.
MARGIN = 1e-2


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-lite-16b",
                                  "zamba2-7b"])
def test_generate_equals_the_reference(arch):
    """Greedy ``generate`` (B = 2, prompts of 6, 8 new tokens, dropless
    MoE) gives the reference's tokens; every greedy step's top-2 margin in
    the reference's teacher-forced logits is guarded."""
    jcfg, cfg, tree, params = _model(arch, seed=2, dropless=True)
    prompts = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 6))
    got = serve.generate(cfg, params, torch.from_numpy(prompts),
                         max_new_tokens=8)
    want = jgenerate(jcfg, tree, jnp.asarray(prompts, jnp.int32),
                     max_new_tokens=8)
    tokens = np.asarray(want["tokens"])
    logits = np.asarray(jax.jit(lambda p, b: jtransformer.forward(
        p, jcfg, b))(tree, {"tokens": jnp.asarray(tokens, jnp.int32)}))
    top2 = np.sort(logits[:, 5:-1], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MARGIN
    assert got["tokens"].shape == (2, 14)
    np.testing.assert_array_equal(got["tokens"].numpy(), tokens)
    assert got["decode_tps"] > 0


def test_serving_entry_points_run_on_the_card_unless_told_otherwise():
    """``init_cache`` and ``serve.main`` resolve no device to the card,
    and so fail here."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = configs.smoke_config("deepseek-v2-lite-16b")
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "deepseek-v2-lite-16b", "--smoke"])
