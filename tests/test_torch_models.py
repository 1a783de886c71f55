"""The port's LM zoo (``repro_torch.models``, ``data``, ``launch``,
``convert.lm_params_from_jax``) against the JAX package's, forward only:
layers, attention on both sides of the dense threshold, Mamba2 at a
ragged length, whole-model logits of the smoke configs (dense, vlm/audio,
ssm, hybrid) on both backends, a hybrid forward past the threshold,
batches and the prefill step (MLA, MoE and decode: test_torch_moe.py and
test_torch_lm_decode.py).
Inputs come from numpy with a seed; weights from the reference, converted.
float32 throughout; each tolerance is stated where it is used."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba2
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.data import pipeline
from repro_torch.launch import make_prefill_step
from repro_torch.models import attention, layers, mamba2, transformer

# Sums of a few hundred float32 products in another order: 2e-5 relative.
TOL = dict(rtol=2e-5, atol=2e-5)
# A whole model: layers compound the order differences, and logits reach
# ~50 in the gemma and mamba2 smoke models.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BACKENDS = ("kernel", "torch")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _module(cls, tree, *args):
    """A port module of ``cls(*args)`` holding the reference's ``tree``."""
    m = cls(*args, dtype=torch.float32)
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    return m


# ----------------------------------------------------------------- layers
def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    scale = rng.standard_normal(24).astype(np.float32)
    norm = layers.RMSNorm(24, torch.float32)
    norm.load_state_dict({"scale": _t(scale)})
    got = layers.rmsnorm(norm, _t(x), 1e-6)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
def test_apply_rope(fraction):
    """Interleaved pairs over the leading fraction of dh; positions up to
    3000, where the angle's float32 rounding matters most."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(3000, 3007)]).astype(np.int64)
    got = layers.apply_rope(_t(x), torch.from_numpy(pos), 10_000.0, fraction)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0,
                              fraction)
    # cos and sin of angles up to 3000 rad: 1 ulp of the angle is 2.4e-4.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    rot = int(32 * fraction) // 2 * 2
    assert torch.equal(got[..., rot:], _t(x)[..., rot:])


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("glu", [True, False])
def test_ffn_apply(act, glu):
    tree = jlayers.ffn_init(jax.random.PRNGKey(2), 16, 40, glu, jnp.float32)
    ffn = _module(layers.FFN, tree, 16, 40, glu)
    x = np.random.default_rng(2).standard_normal((2, 6, 16)).astype(
        np.float32)
    got = layers.ffn_apply(ffn, _t(x), act, glu)
    want = jlayers.ffn_apply(tree, jnp.asarray(x), act, glu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unembed_lm_head_softcap_and_cross_entropy():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 16)).astype(np.float32)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    emb = layers.Embedding(50, 16, torch.float32)
    emb.load_state_dict({"table": _t(table)})
    got = layers.unembed(emb, _t(x), softcap=5.0)
    want = jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x),
                           softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    head = layers.LMHead(16, 50, torch.float32)
    head.load_state_dict({"w": _t(table.T.copy())})
    torch.testing.assert_close(layers.lm_head_apply(head, _t(x), 5.0), got,
                               **TOL)
    labels = rng.integers(0, 50, (2, 4))
    mask = (rng.uniform(size=(2, 4)) < 0.6).astype(np.float32)
    for m in (None, mask):
        ce = layers.softmax_cross_entropy(
            got, torch.from_numpy(labels), None if m is None else _t(m))
        jce = jlayers.softmax_cross_entropy(
            jnp.asarray(want), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(ce), float(jce), **TOL)


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1), (4, 4)],
                         ids=["gqa", "mqa", "mha"])
@pytest.mark.parametrize("threshold", [64, 16],
                         ids=["dense", "flash"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_attention_apply(H, KV, threshold, backend):
    """S = 40 below the threshold (dense) and above it (B7's plain version
    on the kernel backend, ``flash_attention_scan`` on the torch one), with
    partial rotary, against the reference at the same threshold."""
    D, dh, S = 32, 16, 40
    tree = jattn.attention_init(jax.random.PRNGKey(H + KV), D, H, KV, dh,
                                jnp.float32)
    params = _module(attention.Attention, tree, D, H, KV, dh)
    x = np.random.default_rng(4).standard_normal((2, S, D)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).copy()
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=dh, rope_fraction=0.5,
              dense_threshold=threshold)
    got = attention.attention_apply(params, _t(x), torch.from_numpy(pos),
                                    backend=backend, **kw)
    want = jax.jit(lambda p, a, b: jattn.attention_apply(p, a, b, **kw))(
        tree, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_scan_over_several_blocks():
    """The plain long path over three key blocks, the last one ragged."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 70, 2, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 70, 2, 16)).astype(np.float32)
            for _ in range(2))
    for causal in (True, False):
        got = attention.flash_attention_scan(_t(q), _t(k), _t(v), block_k=32,
                                             causal=causal)
        want = jattn.flash_attention_scan(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), block_k=32,
                                          causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------- mamba2
@functools.cache
def _mamba2_case():
    """A Mamba2 block (A_log drawn, so decays differ from 1), its input at
    S = 50 with chunk 16, and the reference's output (computed once)."""
    jcfg = jconfigs.SSMConfig(d_state=8, head_dim=16, chunk=16)
    tree = jmamba2.mamba2_init(jax.random.PRNGKey(6), 32, jcfg, jnp.float32)
    tree = dict(tree, A_log=jnp.asarray(np.random.default_rng(6).uniform(
        -1, 1, tree["A_log"].shape), jnp.float32))
    u = np.random.default_rng(7).standard_normal((2, 50, 32)).astype(
        np.float32)
    ref = jax.jit(lambda p, x: jmamba2.mamba2_apply(p, x, jcfg))
    return tree, u, np.asarray(ref(tree, jnp.asarray(u)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_mamba2_apply_ragged_length(backend):
    """S = 50 with chunk 16 (the last chunk padded), one group: B8's plain
    version (kernel) and ``_ssd_chunked`` (torch) against the reference."""
    cfg = configs.SSMConfig(d_state=8, head_dim=16, chunk=16)
    tree, u, want = _mamba2_case()
    params = _module(mamba2.Mamba2, tree, 32, cfg)
    got = mamba2.mamba2_apply(params, _t(u), cfg, backend=backend)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_causal_conv():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        mamba2._causal_conv(_t(x), _t(w)).numpy(),
        np.asarray(jmamba2._causal_conv(jnp.asarray(x), jnp.asarray(w))),
        **TOL)


# ------------------------------------------------------------ whole model
@functools.cache
def _model(arch, seed=0):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    tree = jtransformer.init_params(jax.random.PRNGKey(seed), jcfg,
                                    jnp.float32)
    return jcfg, cfg, tree, lm_params_from_jax(jax.tree.map(np.asarray, tree),
                                               cfg, device="cpu")


def _jforward(jcfg):
    """The reference's forward, jitted (its eager op-by-op dispatch costs
    seconds per smoke model on the CPU)."""
    return jax.jit(lambda p, b: jtransformer.forward(p, jcfg, b))


def _batches(jcfg, cfg, B, S, step=0):
    shape = jconfigs.InputShape("t", S, B, "prefill")
    jb = jpipeline.make_batch(jcfg, shape, step)
    tb = pipeline.make_batch(cfg, configs.InputShape("t", S, B, "prefill"),
                             step, device="cpu")
    return jb, tb


SMOKE_ARCHS = ["stablelm-1.6b", "gemma-2b", "musicgen-medium",
               "mamba2-1.3b", "zamba2-7b", "internvl2-26b"]


@functools.cache
def _smoke_logits(arch):
    """The reference's logits of a smoke model at B = 2, S = 70 (computed
    once for both backends), with the port's params and batch."""
    jcfg, cfg, tree, params = _model(arch)
    jb, tb = _batches(jcfg, cfg, 2, 70)
    return cfg, params, tb, np.asarray(_jforward(jcfg)(tree, jb))


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_logits_of_smoke_configs(arch, backend):
    """Whole-model logits (B = 2, S = 70: the dense attention path, SSD
    with a ragged last chunk) for dense, audio (codebooks), vlm
    (embeddings), ssm and hybrid stacks."""
    cfg, params, tb, want = _smoke_logits(arch)
    got = transformer.forward(params, cfg, tb, backend=backend)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_hybrid_forward_past_the_dense_threshold():
    """zamba2-7b smoke at B = 1, S = 2176 > 2048: both shared attention
    blocks take the long path (B7's plain version on the kernel backend,
    the reference's ``flash_attention_scan`` in both packages), held
    against the reference's logits."""
    jcfg, cfg, tree, params = _model("zamba2-7b", seed=3)
    jb, tb = _batches(jcfg, cfg, 1, 2176)
    want = np.asarray(_jforward(jcfg)(tree, jb))
    for backend in BACKENDS:
        got = transformer.forward(params, cfg, tb, backend=backend)
        np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_make_batch_equals_the_reference():
    for arch, kind in (("stablelm-1.6b", "train"), ("musicgen-medium",
                                                    "prefill"),
                       ("internvl2-26b", "train"), ("zamba2-7b", "decode")):
        jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
        for step in (0, 3):
            jb = jpipeline.make_batch(jcfg, jconfigs.InputShape(
                "t", 12, 3, kind), step, jpipeline.DataConfig(seed=5))
            tb = pipeline.make_batch(cfg, configs.InputShape(
                "t", 12, 3, kind), step, pipeline.DataConfig(seed=5),
                device="cpu")
            assert sorted(jb) == sorted(tb)
            for name in jb:
                np.testing.assert_array_equal(tb[name].numpy(),
                                              np.asarray(jb[name]))
    it = pipeline.synthetic_batch_iter(cfg, configs.InputShape(
        "t", 4, 2, "prefill"), device="cpu")
    first, second = next(it), next(it)
    assert not torch.equal(first["tokens"], second["tokens"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "gemma-2b"])
def test_make_prefill_step(arch):
    """The last position's logits of the prefill step, both packages."""
    jcfg, cfg, tree, params = _model(arch, seed=4)
    jb, tb = _batches(jcfg, cfg, 2, 33, step=2)
    want = np.asarray(jax.jit(jmake_prefill_step(jcfg))(tree, jb))
    for backend in BACKENDS:
        got = make_prefill_step(cfg, backend)(params, tb)
        assert got.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_init_params_has_the_reference_tree():
    """``init_params`` makes every leaf of the reference's tree (the
    stacked layers one module each), with the reference's fixed values
    and the scale of its draws."""
    for arch in ("zamba2-7b", "gemma-2b", "musicgen-medium"):
        jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
        shapes = jax.eval_shape(lambda: jtransformer.init_params(
            jax.random.PRNGKey(0), jcfg, jnp.float32))
        ref = lm_params_from_jax(jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), shapes), cfg, device="cpu")
        gen = torch.Generator().manual_seed(0)
        lm = transformer.init_params(cfg, generator=gen, device="cpu",
                                     dtype=torch.float32)
        got = {n: p.shape for n, p in lm.named_parameters()}
        assert got == {n: p.shape for n, p in ref.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    for got, want in (
            (attention.attention_init(32, 4, 2, 16, torch.float32,
                                      generator=gen),
             jattn.attention_init(jax.random.PRNGKey(0), 32, 4, 2, 16,
                                  jnp.float32)),
            (mamba2.mamba2_init(32, configs.SSMConfig(d_state=8, head_dim=16),
                                torch.float32, generator=gen),
             jmamba2.mamba2_init(jax.random.PRNGKey(0), 32, jconfigs.SSMConfig(
                 d_state=8, head_dim=16), jnp.float32)),
            (layers.ffn_init(32, 48, True, torch.float32, generator=gen),
             jlayers.ffn_init(jax.random.PRNGKey(0), 32, 48, True,
                              jnp.float32))):
        flat = params_from_jax(jax.tree.map(np.asarray, want))
        assert {n: tuple(p.shape) for n, p in got.named_parameters()} == \
            {n: tuple(a.shape) for n, a in flat.items()}
    cfg = configs.smoke_config("zamba2-7b")
    lm = transformer.init_params(cfg, device="cpu", dtype=torch.float32)
    blk = lm.stack[0].ssm
    assert torch.equal(blk.A_log, torch.zeros_like(blk.A_log))
    assert torch.equal(blk.D, torch.ones_like(blk.D))
    assert torch.equal(blk.norm.scale, torch.ones_like(blk.norm.scale))
    std = float(blk.w_x.std())                   # normal / sqrt(d_model)
    assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.1, std
    assert abs(float(lm.embed.table.std()) - 1.0) < 0.05


def test_entry_points_run_on_the_card_unless_told_otherwise():
    """With no device the entry points ask for the card, and fail here."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = configs.smoke_config("zamba2-7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.make_batch(cfg, configs.InputShape("t", 4, 1, "prefill"))


def test_lm_params_from_jax_runs_on_the_card_unless_told_otherwise():
    """Like ``init_params``, the conversion resolves no device to the card,
    and so fails here; asked for the CPU it converts."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    jcfg, cfg = jconfigs.smoke_config("gemma-2b"), configs.smoke_config(
        "gemma-2b")
    shapes = jax.eval_shape(lambda: jtransformer.init_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_jax(tree, cfg)
    lm = lm_params_from_jax(tree, cfg, device="cpu")
    assert {p.device.type for p in lm.parameters()} == {"cpu"}


def test_configs_are_the_references():
    """The copied configs (pure Python) equal the reference's, field for
    field, smoke configs included."""
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for name in configs.ARCH_NAMES:
        for get in ("get_config", "smoke_config"):
            got = getattr(configs, get)(name)
            want = getattr(jconfigs, get)(name)
            assert repr(got) == repr(want), name
            assert got.param_count() == want.param_count()
