"""The port's masked attention (``repro_torch.kernels.flash_attention``, its
plain versions on the CPU) against the JAX package's ``mha`` (Pallas, in
interpret mode) and its dense ``attention_ref``: forward, gradients through
the ``autograd.Function``, the lse and the backward formula on their own,
fully masked rows and the wrapper's checks.  Inputs come from numpy with a
seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import mha_bwd_kernels
from repro.kernels.flash_attention.ops import _mha_fwd_impl
from repro.kernels.flash_attention.ops import mha as jmha
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro_torch.kernels.flash_attention import (attention_ref, mha,
                                                 mha_bwd_dkv, mha_bwd_dq,
                                                 mha_bwd_ref, mha_fwd,
                                                 mha_fwd_ref)
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS, MHA_KINDS,
                                                        MHA_MAX_WARPS,
                                                        mha_plan)

# tests/test_kernels.py's MHA_SHAPES: S = 1 + queue_cap for caps 48, 128
# and 64 (no block multiple), with the reference's block size.
MHA_SHAPES = [(49, 16, 32), (129, 32, 64), (65, 8, 128)]
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _case(S, dh, seed, BH=8):
    """q, k, v (BH, S, dh) and lengths including 0, 1, S // 2 and S."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BH, S, dh)).astype(np.float32)
               for _ in range(3))
    lens = np.asarray([0, 1, 3, S // 2, max(S - 1, 1), S, 2, S // 3][:BH],
                      np.float32)
    return q, k, v, lens


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("S,dh,block", MHA_SHAPES)
def test_forward_matches_reference(S, dh, block):
    q, k, v, lens = _case(S, dh, seed=S)
    out = mha(*_t(q, k, v), torch.from_numpy(lens)).numpy()
    jx = [jnp.asarray(a) for a in (q, k, v, lens)]
    ref_kernel = jmha(*jx, block_q=block, block_k=block, interpret=True)
    ref_dense = jattention_ref(*jx[:3], causal=False, lengths=jx[3])
    np.testing.assert_allclose(out, np.asarray(ref_kernel), **FWD_TOL)
    np.testing.assert_allclose(out, np.asarray(ref_dense), **FWD_TOL)
    dense = attention_ref(*_t(q, k, v), causal=False,
                          lengths=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(dense, np.asarray(ref_dense), **FWD_TOL)


@pytest.mark.parametrize("S,dh,block", MHA_SHAPES)
def test_gradients_match_reference(S, dh, block):
    """The vjp of a fixed cotangent through the port's ``mha`` against
    ``jax.grad`` through the reference's ``mha`` and ``attention_ref``."""
    q, k, v, lens = _case(S, dh, seed=S + 1)
    ct = np.sin(np.arange(S * dh) * 0.13).reshape(1, S, dh).astype(np.float32)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = mha(tq, tk, tv, torch.from_numpy(lens))
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                              (tq, tk, tv))
    jl = jnp.asarray(lens)

    def vjp(f):
        return jax.grad(lambda q, k, v: (f(q, k, v) * ct).sum(), (0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))

    refs = (vjp(lambda q, k, v: jmha(q, k, v, jl, block_q=block,
                                     block_k=block, interpret=True)),
            vjp(lambda q, k, v: jattention_ref(q, k, v, causal=False,
                                               lengths=jl)))
    for ref in refs:
        for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       err_msg=name, **GRAD_TOL)


def test_lse_and_backward_formula_match_the_reference_kernels():
    """``mha_fwd_ref``'s lse against the Pallas forward's, and
    ``mha_bwd_ref`` against ``mha_bwd_kernels`` on the same (q, k, v, do,
    lse, delta, lengths), S = 129 with a 64 block (fully masked rows
    included)."""
    S, dh, block = 129, 16, 64
    q, k, v, lens = _case(S, dh, seed=7)
    do = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    jx = [jnp.asarray(a) for a in (q, k, v, lens)]
    jo, jlse = _mha_fwd_impl(*jx, block, block, True)
    o, lse = mha_fwd_ref(*_t(q, k, v), torch.from_numpy(lens))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    valid = lens > 0
    np.testing.assert_allclose(lse.numpy()[valid], np.asarray(jlse)[valid],
                               **FWD_TOL)
    assert (lse.numpy()[~valid] < -1e29).all()
    assert np.isfinite(lse.numpy()).all()
    delta = (do * np.asarray(jo)).sum(-1)
    pad = (-S) % block
    padded = [jnp.pad(jnp.asarray(a), [(0, 0), (0, pad)]
                      + [(0, 0)] * (a.ndim - 2))
              for a in (q, k, v, do, np.asarray(jlse), delta)]
    jgrads = mha_bwd_kernels(*padded, jx[3], block_q=block, block_k=block,
                             interpret=True)
    grads = mha_bwd_ref(*_t(q, k, v, do, np.asarray(jlse), delta),
                        torch.from_numpy(lens))
    for g, r, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r)[:, :S],
                                   err_msg=name, **GRAD_TOL)
    # The wrappers' CPU path is the plain version, call for call.
    args = _t(q, k, v, do, lse.numpy(), delta) + [torch.from_numpy(lens)]
    assert torch.equal(mha_bwd_dq(*args), mha_bwd_ref(*args)[0])
    for a, b in zip(mha_bwd_dkv(*args), mha_bwd_ref(*args)[1:]):
        assert torch.equal(a, b)
    for a, b in zip(mha_fwd(*args[:3], args[-1]), (o, lse)):
        assert torch.equal(a, b)


def test_fully_masked_is_exactly_zero():
    """Length 0 everywhere: outputs AND all gradients exactly 0, finite."""
    q, k, v, _ = _case(33, 8, seed=5)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = mha(tq, tk, tv, torch.zeros(8))
    assert torch.equal(out, torch.zeros_like(out))
    grads = torch.autograd.grad(out.sum(), (tq, tk, tv))
    for g, name in zip(grads, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, torch.zeros_like(g)), name


def test_no_lengths_is_dense_attention():
    q, k, v, _ = _case(40, 16, seed=9)
    out = mha(*_t(q, k, v))
    ref = jattention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)
    # Lengths past Sk are clamped to Sk.
    assert torch.equal(mha(*_t(q, k, v), torch.full((8,), 1e6)), out)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, lens = _t(*_case(17, 8, seed=2))
    with pytest.raises(ValueError, match="contiguous"):
        mha(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, lens)
    with pytest.raises(TypeError, match="float32"):
        mha_fwd(q.double(), k.double(), v.double(), lens)
    with pytest.raises(ValueError, match="shape mismatch"):
        mha_fwd(q, k[:, :, :4].contiguous(), v, lens)
    with pytest.raises(ValueError, match="shape mismatch"):
        mha_fwd(q, k, v, lens[:3])
    with pytest.raises(ValueError, match="expected q"):
        mha_fwd(q[0], k[0], v[0], lens)
    o, lse = mha_fwd(q, k, v, lens)
    with pytest.raises(ValueError, match="shape mismatch"):
        mha_bwd_dq(q, k, v, o, lse[:, :5].contiguous(), lse, lens)


# The card's parity grid's (BH, S) (tests/test_torch_cuda.py::MHA_GRID and
# chip_smoke.py's), each planned at every instantiated dh; an H100's SMs.
PLAN_SHAPES = [(4, 129), (32, 129), (256, 129), (8, 49), (8, 257), (8, 65),
               (8, 1), (8, 16), (8, 17), (8, 128), (8, 600)]
SMS = 132


@pytest.mark.parametrize("kind", MHA_KINDS)
def test_plan_holds_each_batch_head_in_one_block_on_the_main_path(kind):
    """(256, 129, 16), the device engine's and the trainer's launch: one
    block of 9 warps per batch-head, no block with fewer than 16 rows, and
    all 129 keys (queries for dkv) in one shared stage."""
    plan = mha_plan(kind, 256, 129, 129, 16, SMS)
    assert (plan.rows, plan.tiles, plan.stages) == (144, 1, 1)
    assert plan.stage >= 129
    last = 129 - plan.rows * (plan.tiles - 1)
    assert min(plan.rows, last) >= 16


@pytest.mark.parametrize("kind", ["mha_fwd", "mha_bwd_dq"])
def test_plan_splits_query_rows_where_batch_heads_are_few(kind):
    """The service's BH = 4: three blocks of 3 warps per batch-head (48,
    48 and 33 rows), so 12 blocks, not 4, share the work."""
    plan = mha_plan(kind, 4, 129, 129, 16, SMS)
    assert (plan.rows, plan.tiles) == (48, 3)
    assert mha_plan("mha_bwd_dkv", 4, 129, 129, 16, SMS).tiles == 1


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("kind", MHA_KINDS)
def test_plans_fit_the_card_over_the_parity_grid(kind, dh):
    """Every plan at the grid's shapes: shared memory within 227 KB, whole
    warps within the kernel's most, tiles that cover the rows with no
    empty block, and one stage only when it holds the other side."""
    for bh, s in PLAN_SHAPES:
        plan = mha_plan(kind, bh, s, s, dh, SMS)
        assert plan.smem <= 227 * 1024, (bh, s, plan)
        assert plan.rows % 16 == 0
        assert 16 <= plan.rows <= 16 * MHA_MAX_WARPS[dh], (bh, s, plan)
        assert plan.rows * (plan.tiles - 1) < s <= plan.rows * plan.tiles
        assert plan.stage % 16 == 0
        assert plan.stages == (1 if plan.stage >= s else 2), (bh, s, plan)
    if dh == 16:      # S = 600 is tiled beyond one block per batch-head
        assert mha_plan(kind, 8, 600, 600, dh, SMS).tiles > 1


def test_plan_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head dim"):
        mha_plan("mha_fwd", 4, 129, 129, 12, SMS)
    with pytest.raises(ValueError, match="unknown kernel"):
        mha_plan("mha", 4, 129, 129, 16, SMS)


def test_build_key_covers_the_local_headers(tmp_path):
    """A kernel library is built again when a header its source includes
    from its own directory changes: the build key hashes both (B5 and B6
    share ``csrc/mha_common.cuh``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel
    for source in (kernel.SOURCE, kernel.BWD_SOURCE):
        header = source.with_name("mha_common.cuh").read_bytes()
        assert header in _build._key_bytes(source)
    src, hdr = tmp_path / "k.cu", tmp_path / "h.cuh"
    src.write_text('#include "h.cuh"\n#include <cuda_runtime.h>\n')
    hdr.write_text("// one\n")
    first = _build._key_bytes(src)
    hdr.write_text("// two\n")
    assert _build._key_bytes(src) != first
