"""The LM zoo's kernels in the port, on their plain paths (the CPU), against
the JAX package: ``flash_attention`` (B7) against the Pallas
``flash_attention`` in interpret mode and the dense ``attention_ref``;
``ssd`` (B8) against the Pallas ``ssd`` in interpret mode and the exact
recurrence ``ssd_ref``; the model's ``_ssd_chunked`` against the
reference's.  Inputs come from numpy with a seed; the tolerances are the
reference tests' (``tests/test_kernels.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.ssd.ops import ssd as jssd
from repro.kernels.ssd.ref import ssd_ref as jssd_ref
from repro.models.mamba2 import _ssd_chunked as j_ssd_chunked
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_ref, kernel)
from repro_torch.kernels.ssd import (ssd, ssd_chunk_ref, ssd_chunk_scan_ref,
                                     ssd_chunk_state_ref, ssd_plain, ssd_ref,
                                     ssd_state_pass_ref)
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ref import prepare
from repro_torch.models.mamba2 import _ssd_chunked

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a: np.ndarray, dtype: str):
    """One float32 numpy array as a JAX array and a tensor of ``dtype``
    (the same bfloat16 values on both sides)."""
    jd, td = DT[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


# ------------------------------------------------------------------- B7
# tests/test_kernels.py's grid (B, S, H, KV, dh).
FLASH_GRID = [(1, 128, 2, 2, 64), (2, 200, 4, 2, 64), (1, 384, 8, 1, 128),
              (2, 256, 6, 6, 32)]


@pytest.mark.parametrize("B,S,H,KV,dh", FLASH_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(B, S, H, KV, dh, dtype, causal):
    rng = np.random.default_rng(S + H)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == DT[dtype][1] and out.shape == (B, S, H, dh)
    np.testing.assert_allclose(_np(out), _np(jflash(jq, jk, jv,
                                                    causal=causal)),
                               **TOL[dtype])

    def flat(a):                        # repeat KV heads, (B*H, S, dh)
        a = jnp.repeat(a, H // a.shape[2], 2)
        return a.transpose(0, 2, 1, 3).reshape(B * H, S, dh)

    dense = jattention_ref(flat(jq), flat(jk), flat(jv), causal=causal)
    dense = dense.reshape(B, H, S, dh).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(out), _np(dense), **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_unequal_lengths(causal):
    """Sq != Sk: the reference's cross-length case (non-causal), and the
    causal mask aligned top-left, as in the Pallas kernel."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 100, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 260, 4, 64)).astype(np.float32)
            for _ in range(2))
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])
    if not causal:
        dense = jattention_ref(
            *(jnp.asarray(a).transpose(0, 2, 1, 3).reshape(8, -1, 64)
              for a in (q, k, v)), causal=False)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(dense).reshape(2, 4, 100, 64)
            .transpose(0, 2, 1, 3), **TOL["float32"])


def test_flash_plain_version_is_the_dense_attention():
    """The port's own plain versions agree: ``flash_attention_ref`` (B7's)
    and the dense ``attention_ref`` with the KV heads repeated, causal."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 70, 6, 32))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 70, 2, 32))
                             .astype(np.float32)) for _ in range(2))
    got = flash_attention_ref(q, k, v, causal=True)
    flat = lambda t: (t.repeat_interleave(6 // t.shape[2], 2)
                      .transpose(1, 2).reshape(12, 70, 32))
    want = attention_ref(flat(q), flat(k), flat(v), causal=True)
    torch.testing.assert_close(got.transpose(1, 2).reshape(12, 70, 32),
                               want, rtol=1e-5, atol=1e-5)


def test_flash_attention_checks_its_operands():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)


@pytest.mark.parametrize("dh", [16, 32, 64, 112, 128, 192, 256])
def test_flash_plan_picks_a_kernel_by_dtype_and_head_dim(dh):
    """float32 goes to the 3xTF32 kernel at dh as it is, with 64-key tiles
    up to dh 128 and 32 beyond; bfloat16 to the wgmma kernel at dh padded
    to whole 64-column TMA boxes, with a key tile that keeps Q and two
    stages of K and V within a block's 227 KB of shared memory."""
    assert kernel.flash_plan(torch.float32, dh) == (
        "flash_fwd", dh, 64 if dh <= 128 else 32)
    name, dh_pad, key_tile = kernel.flash_plan(torch.bfloat16, dh)
    assert name == "flash_fwd_sm90"
    assert dh_pad % 64 == 0 and dh <= dh_pad < dh + 64
    assert key_tile == (128 if dh_pad <= 128 else 64)
    smem = 2 * dh_pad * (128 + 2 * 2 * key_tile) + 1024
    assert smem <= 232448, smem


@pytest.mark.parametrize("dh", [16, 32, 64, 112, 128, 192, 256])
def test_flash_plan_routes_float32_to_flash_fwd(dh):
    """Every head dim's float32 call goes to ``flash_fwd``, never to the
    bfloat16 kernel, and its geometry fits a block: the Q tile (rows
    padded by 8 floats) and two stages of K (by 8) and V (by 4) of
    ``key_tile`` keys within 227 KB of shared memory; 8 warps (128 query
    rows) share a tile up to dh 128, 4 warps beyond."""
    name, dh_pad, key_tile = kernel.flash_plan(torch.float32, dh)
    assert (name, dh_pad) == ("flash_fwd", dh)
    q_rows = 128 if dh <= 128 else 64
    smem = 4 * (2 * key_tile * ((dh + 8) + (dh + 4)) + q_rows * (dh + 8))
    assert smem <= 232448, smem
    assert key_tile % 8 == 0 and dh % 16 == 0


def test_flash_plan_refuses_what_has_no_kernel():
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_plan(torch.bfloat16, 48)
    with pytest.raises(TypeError, match="dtype"):
        kernel.flash_plan(torch.float16, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cpu_call_counts_no_launch(dtype):
    """A CPU tensor takes the plain version and adds to neither B7's count
    nor its count by kernel."""
    q, k, v = (torch.ones(1, 8, 2, 16, dtype=dtype) for _ in range(3))
    launches = flash_attention.launches
    by_kernel = dict(flash_attention.kernel_launches)
    out = flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape
    assert flash_attention.launches == launches
    assert flash_attention.kernel_launches == by_kernel
    assert set(by_kernel) == {"flash_fwd", "flash_fwd_sm90"}


# ------------------------------------------------------------------- B8
# tests/test_kernels.py's grid (B, S, H, P, N, chunk).
SSD_GRID = [(1, 64, 2, 16, 8, 16), (2, 100, 3, 16, 8, 32),
            (1, 256, 4, 32, 16, 64)]


def _ssd_case(B, S, H, P, N, seed, G=None):
    """The reference test's distributions, in numpy: x normal, dt
    softplus(normal), dA = -dt exp(0.3 normal per head), B and C 0.3
    normal (per head, or per group with ``G``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    dA = (-dt * np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    bm, cm = ((rng.standard_normal((B, S, G or H, N)) * 0.3)
              .astype(np.float32) for _ in range(2))
    return x, dt, dA, bm, cm


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_matches_reference(B, S, H, P, N, chunk, dtype):
    """x, B and C in ``dtype`` (dt, dA float32), as the reference test
    makes them: the port's ``ssd`` against the Pallas ``ssd`` and against
    ``ssd_ref``, both the reference's and the port's."""
    x, dt, dA, bm, cm = _ssd_case(B, S, H, P, N, seed=S)
    (jx, tx), (jb, tb), (jc, tc) = (_both(a, dtype) for a in (x, bm, cm))
    jdt, jdA = jnp.asarray(dt), jnp.asarray(dA)
    tdt, tdA = torch.from_numpy(dt), torch.from_numpy(dA)
    y = ssd(tx, tdt, tdA, tb, tc, chunk=chunk)
    assert y.dtype == DT[dtype][1] and y.shape == (B, S, H, P)
    np.testing.assert_allclose(_np(y), _np(jssd(jx, jdt, jdA, jb, jc,
                                                 chunk=chunk)),
                               **SSD_TOL[dtype])

    def jflat(a, d):
        return a.transpose(0, 2, 1, 3).reshape(B * H, S, d)

    col = lambda a: a.transpose(0, 2, 1).reshape(B * H, S, 1)
    yr = jssd_ref(jflat(jx, P), col(jdt), col(jdA), jflat(jb, N),
                  jflat(jc, N))
    yr = np.asarray(yr, np.float32).reshape(B, H, S, P).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(y), yr, **SSD_TOL[dtype])
    tflat = lambda t, d: t.transpose(1, 2).reshape(B * H, S, d)
    tcol = lambda t: t.transpose(1, 2).reshape(B * H, S, 1)
    yt = ssd_ref(tflat(tx, P), tcol(tdt), tcol(tdA), tflat(tb, N),
                 tflat(tc, N))
    np.testing.assert_allclose(
        _np(yt).reshape(B, H, S, P).transpose(0, 2, 1, 3), yr,
        **SSD_TOL[dtype])


def test_ssd_reads_groups_as_the_reference_repeats_them():
    """B and C by group (G = 1 over 4 heads, the models' n_groups) give what
    the reference gives with them repeated per head, float32 out of
    bfloat16-free float32 inputs, at a ragged S (pad inside the wrapper)."""
    B, S, H, P, N, chunk = 2, 75, 4, 16, 8, 32
    x, dt, dA, bm, cm = _ssd_case(B, S, H, P, N, seed=11, G=1)
    y = ssd(*(torch.from_numpy(a) for a in (x, dt, dA, bm, cm)), chunk=chunk,
            out_dtype=torch.float32)
    rep = lambda a: jnp.repeat(jnp.asarray(a), H, axis=2)
    ref = jssd(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(dA), rep(bm),
               rep(cm), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **SSD_TOL["float32"])


def test_ssd_chunk_ref_is_the_pallas_kernel_body():
    """The plain chunked version on the Pallas kernel's own operands
    (flattened per batch-head, l = the in-chunk cumsum), against the
    Pallas wrapper: the same arithmetic, so within 1e-5."""
    B, S, H, P, N, chunk = 1, 128, 2, 16, 8, 32
    x, dt, dA, bm, cm = _ssd_case(B, S, H, P, N, seed=5)
    tdt, l = prepare(torch.from_numpy(dt), torch.from_numpy(dA), S, chunk)
    flat = lambda a, d: torch.from_numpy(a).transpose(1, 2).reshape(B * H,
                                                                     S, d)
    col = lambda t: t.transpose(1, 2).reshape(B * H, S, 1)
    y = ssd_chunk_ref(flat(x, P), col(tdt), col(l), flat(bm, N), flat(cm, N),
                      chunk)
    ref = jssd(*(jnp.asarray(a) for a in (x, dt, dA, bm, cm)), chunk=chunk)
    np.testing.assert_allclose(
        y.reshape(B, H, S, P).transpose(1, 2).numpy(), np.asarray(ref),
        rtol=1e-5, atol=1e-5)
    plain = ssd_plain(*(torch.from_numpy(a) for a in (x, dt, dA, bm, cm)),
                      chunk=chunk)
    torch.testing.assert_close(plain, y.reshape(B, H, S, P).transpose(1, 2))


def test_model_chunked_ssd_matches_reference():
    """The model's vectorised chunked SSD (a loop over chunks where the
    reference runs an associative scan) against the reference's, and both
    against the exact recurrence, as ``tests/test_kernels.py`` holds it."""
    B, S, H, P, N, chunk, G = 2, 128, 4, 16, 8, 32, 2
    x, dt, dA, bm, cm = _ssd_case(B, S, H, P, N, seed=9, G=G)
    y = _ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, dA, bm, cm)),
                     chunk)
    ref = j_ssd_chunked(*(jnp.asarray(a) for a in (x, dt, dA, bm, cm)),
                        chunk)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    rep = lambda a: np.repeat(a, H // G, axis=2)
    flat = lambda a, d: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(B * H,
                                                                      S, d)
    col = lambda a: jnp.asarray(a).transpose(0, 2, 1).reshape(B * H, S, 1)
    yr = jssd_ref(flat(x, P), col(dt), col(dA), flat(rep(bm), N),
                  flat(rep(cm), N))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(yr).reshape(B, H, S, P).transpose(0, 2, 1, 3),
        **SSD_TOL["float32"])


def test_ssd_checks_its_operands():
    x, dt, dA, bm, cm = (torch.from_numpy(a)
                         for a in _ssd_case(1, 32, 4, 16, 8, seed=1, G=3))
    with pytest.raises(ValueError, match="shape"):
        ssd(x, dt, dA, bm, cm, chunk=16)          # 3 groups do not divide 4
    bm, cm = bm[:, :, :2].contiguous(), cm[:, :, :2].contiguous()
    with pytest.raises(TypeError, match="dtype"):
        ssd(x, dt, dA, bm.double(), cm, chunk=16)
    with pytest.raises(TypeError, match="dtype"):
        ssd(x, dt, dA, bm, cm, chunk=16, out_dtype=torch.float16)


# The reference tests' grid (B, S, H, P, N, chunk) with a group per head,
# then a ragged S with G < H.
PASS_GRID = [(b, s, h, p, n, chunk, h) for b, s, h, p, n, chunk in SSD_GRID] \
    + [(2, 75, 4, 16, 8, 32, 1), (1, 200, 6, 16, 16, 64, 2)]


def _three_passes(x, dt, dA, bm, cm, chunk):
    """The three plain passes the CUDA kernels compute, on the models'
    layout (the wrapper's preparation and padding, as ``ssd_plain``):
    -> (y (b, S, H, P), the flattened operands of ``ssd_chunk_ref``)."""
    b, S, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    dtp, l = prepare(dt, dA, S, chunk)
    Sp = dtp.shape[1]
    group = torch.arange(H) // (H // G)

    def flat(t, d):
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Sp - S))
        return t.transpose(1, 2).reshape(b * H, Sp, d)

    col = lambda t: t.transpose(1, 2).reshape(b * H, Sp, 1)
    ops = (flat(x, P), col(dtp), col(l), flat(bm[:, :, group], N),
           flat(cm[:, :, group], N))
    states = ssd_chunk_state_ref(*ops[:4], chunk)
    assert states.shape == (b * H, Sp // chunk, N, P)
    h = ssd_state_pass_ref(states, ops[2], chunk)
    y = ssd_chunk_scan_ref(*ops, h, chunk)
    return y.reshape(b, H, Sp, P).transpose(1, 2)[:, :S], ops


@pytest.mark.parametrize("B,S,H,P,N,chunk,G", PASS_GRID)
def test_ssd_three_passes_compose_to_the_chunked_ssd(B, S, H, P, N, chunk,
                                                     G):
    """The three passes B8's kernels compute (chunk states, the state pass,
    the chunk scan), composed, equal ``ssd_chunk_ref`` on the same
    operands, the Pallas ``ssd`` in interpret mode and the model's
    ``_ssd_chunked`` (the reference's and the port's), float32, within
    1e-5."""
    x, dt, dA, bm, cm = _ssd_case(B, S, H, P, N, seed=S + N, G=G)
    y, ops = _three_passes(*(torch.from_numpy(a)
                             for a in (x, dt, dA, bm, cm)), chunk)
    tol = dict(rtol=1e-5, atol=1e-5)
    want = ssd_chunk_ref(*ops, chunk).reshape(B, H, -1, P).transpose(1, 2)
    np.testing.assert_allclose(y.numpy(), want[:, :S].numpy(), **tol)
    rep = lambda a: jnp.repeat(jnp.asarray(a), H // G, axis=2)
    pallas = jssd(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(dA), rep(bm),
                  rep(cm), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), **tol)
    pad = (-S) % chunk
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (x, dt, dA, bm, cm)]
    model = j_ssd_chunked(*(jnp.asarray(a) for a in padded), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(model)[:, :S], **tol)
    port = _ssd_chunked(*(torch.from_numpy(a) for a in padded), chunk)
    np.testing.assert_allclose(y.numpy(), port[:, :S].numpy(), **tol)


# (B, S, H, P, N, chunk): zamba2-7b's and mamba2-1.3b's prefill, a ragged
# S, and the reference tests' grid.
PLAN_SHAPES = [(2, 4096, 112, 64, 64, 256), (2, 3000, 112, 64, 64, 256),
               (2, 3000, 64, 64, 128, 256), (1, 2176, 8, 16, 16, 32)] + \
    SSD_GRID


@pytest.mark.parametrize("B,S,H,P,N,chunk", PLAN_SHAPES)
def test_ssd_plan_covers_the_sequence_and_the_state(B, S, H, P, N, chunk):
    """B8's workspace holds one float32 (N, P) state per (batch, head,
    chunk) of the padded sequence, the layout the three passes index."""
    shape = ssd_kernel.workspace_shape(B, S, H, N, P, chunk)
    n_chunks = shape[2]
    assert shape == (B, H, n_chunks, N, P)
    assert (n_chunks - 1) * chunk < S <= n_chunks * chunk


def test_ssd_cpu_call_counts_no_launch():
    """A CPU tensor takes the plain version and adds to neither B8's count
    nor any pass's."""
    x, dt, dA, bm, cm = (torch.from_numpy(a)
                         for a in _ssd_case(1, 40, 2, 16, 8, seed=2, G=1))
    launches = ssd.launches
    by_kernel = dict(ssd.kernel_launches)
    assert ssd(x, dt, dA, bm, cm, chunk=16).shape == x.shape
    assert ssd.launches == launches and ssd.kernel_launches == by_kernel
    assert tuple(by_kernel) == ssd_kernel.PASSES
