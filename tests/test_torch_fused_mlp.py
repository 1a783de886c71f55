"""The port's fused dense layer, forward and backward, against the JAX
package's fused-MLP kernels (Pallas, interpret mode on the CPU, as
tests/test_kernels.py runs them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_mlp.kernel import (fused_mlp_dgrad_layer,
                                            fused_mlp_wgrad_layer)
from repro.kernels.fused_mlp.ops import fused_mlp as jax_fused_mlp
from repro_torch.kernels.fused_mlp import (fused_mlp, fused_mlp_dgrad,
                                           fused_mlp_dgrad_ref,
                                           fused_mlp_wgrad,
                                           fused_mlp_wgrad_ref, kernel)
from repro_torch.kernels.fused_mlp.ref import ACTIVATIONS

# The JAX package's own tolerances (tests/test_kernels.py::tol).
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (37, 300, 129),
                                   (200, 1000, 513)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_matches_reference_kernel(m, k, n, dtype, act):
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(m, k, n, seed=m * 7 + n)
    # Both sides round the same float32 draws to the working dtype.
    ref = jax_fused_mlp(*(jnp.asarray(a).astype(jdt) for a in arrays),
                        activation=act)
    launches = fused_mlp.launches
    with torch.no_grad():
        out = fused_mlp(*(torch.from_numpy(a).to(tdt) for a in arrays),
                        activation=act)
    assert fused_mlp.launches == launches          # CPU: plain version
    assert out.dtype == tdt and tuple(out.shape) == (m, n)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_one_dimensional_x():
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 40, 24, seed=3))
    with torch.no_grad():
        y1 = fused_mlp(x[0], w, b, activation="tanh")
        y2 = fused_mlp(x, w, b, activation="tanh")
    assert y1.shape == (24,)
    assert torch.equal(y1, y2[0])


def test_rejects_what_the_kernel_does_not_take():
    x, w, b = (torch.from_numpy(a) for a in _inputs(4, 16, 8, seed=0))
    with torch.no_grad():
        with pytest.raises(TypeError, match="dtype"):
            fused_mlp(x.double(), w.double(), b.double())
        with pytest.raises(TypeError, match="one dtype"):
            fused_mlp(x, w.to(torch.bfloat16), b)
        with pytest.raises(ValueError, match="shape mismatch"):
            fused_mlp(x, w[:-1], b)
        with pytest.raises(ValueError, match="shape mismatch"):
            fused_mlp(x, w, b[:-1])
        with pytest.raises(ValueError, match="expected x"):
            fused_mlp(x[None], w, b)
        with pytest.raises(ValueError, match="contiguous"):
            fused_mlp(x.t().contiguous().t(), w, b)
        with pytest.raises(ValueError, match="empty"):
            fused_mlp(x[:0], w, b)
        with pytest.raises(ValueError, match="unknown activation"):
            fused_mlp(x, w, b, activation="gelu")
    # With autograd on, the wrapper is differentiable: the gradient flows.
    w = w.clone().requires_grad_()
    fused_mlp(x, w, b).sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape
    assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0


@pytest.mark.parametrize("m,k,n", [(1, 11410, 4000), (16, 11410, 4000),
                                   (16, 4000, 1000), (16, 1000, 512),
                                   (16, 2, 128), (37, 512, 120), (16, 63, 12)])
def test_split_plan_covers_k(m, k, n):
    _, _, splits, chunk = kernel.forward_plan(m, k, n, sm_count=132)
    assert 1 <= splits <= 65535
    assert (splits - 1) * chunk < k <= splits * chunk   # no empty split
    assert splits == 1 or chunk >= kernel.MIN_SPLIT_ROWS


@pytest.mark.parametrize("m", [1, 2, 8, 16, 17, 33, 64, 65, 128, 8192,
                               8256])
def test_forward_plan_picks_a_kernel_by_m(m):
    """M <= 16 keeps the kernel that holds all rows in registers; M > 16
    goes to the kernel whose blocks take 64 rows, so W is read once per 64
    rows (one M tile at M = 64, 129 at the encoder's 8,256)."""
    name, tile_m, _, _ = kernel.forward_plan(m, 11410, 4000, sm_count=132)
    if m <= 16:
        assert (name, tile_m) == ("fused_mlp_fwd", kernel.MAX_TILE_M)
    else:
        assert (name, tile_m) == ("fused_mlp_fwd_m64", kernel.M64_TILE_M)
        assert -(-m // tile_m) == -(-m // 64)


@pytest.mark.parametrize("m", [17, 64, 65, 8256])
@pytest.mark.parametrize("k,n", [(11410, 4000), (4000, 1000), (1000, 512),
                                 (2, 128), (512, 12), (4, 64), (64, 64),
                                 (64, 128), (128, 64), (63, 7)])
def test_forward_plan_split_covers_k(m, k, n):
    """The M > 16 kernel's K split covers K with no empty range, in whole
    32-row ring stages, and fills one wave of the card where the tiles do
    not: the 11410 x 4000 layer at M = 64 (32 column tiles) gets 8 ranges,
    256 blocks for 2 x 132 slots; where the tiles reach half the SMs, K is
    not split."""
    name, tile_m, splits, chunk = kernel.forward_plan(m, k, n, sm_count=132)
    assert name == "fused_mlp_fwd_m64"
    assert 1 <= splits <= 65535 and chunk % kernel.M64_STEP_K == 0
    assert (splits - 1) * chunk < k <= splits * chunk   # no empty split
    assert splits == 1 or chunk >= kernel.MIN_SPLIT_ROWS
    tiles = -(-n // kernel.TILE_N) * -(-m // tile_m)
    if splits > 1:      # never more blocks than one wave holds
        assert tiles * splits <= kernel.M64_BLOCKS_PER_SM * 132
    if 2 * tiles > 132:  # the encoder's 129 tiles: no split
        assert splits == 1
    if (m, k, n) == (64, 11410, 4000):
        assert (splits, chunk) == (8, 1440)


# ------------------------------------------------------------- backward
# tests/test_kernels.py's gradient grid (DFP_GRAD_SHAPES) and tolerances:
# float32 at rtol 1e-3, atol 1e-4; bfloat16 at 2e-2.
GRAD_SHAPES = [(1, 1000, 512), (3, 512, 128), (5, 4000, 1000),
               (37, 300, 129)]
GRAD_TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _grad_inputs(m, k, n, seed):
    """tests/test_kernels.py's scales: x ~ N(0, 1), w * 0.05, b * 0.1, and
    the cotangent sin(0.37 j) of its ``_grads``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    ct = np.sin(np.arange(n) * 0.37).astype(np.float32)
    return x, w, b, ct


@pytest.mark.parametrize("m,k,n", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_backward_matches_reference_vjp(m, k, n, dtype, act):
    """dx, dW, db of sum(fused_mlp(x, w, b) * ct) against ``jax.grad`` of
    the JAX package's custom VJP (its dgrad and wgrad Pallas kernels)."""
    jdt, tdt = DTYPES[dtype]
    x, w, b, ct = _grad_inputs(m, k, n, seed=m * 31 + n)
    ref = jax.grad(
        lambda x, w, b: (jax_fused_mlp(x, w, b, activation=act)
                         .astype(jnp.float32) * ct).sum(), (0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (x, w, b)))
    tx, tw, tb = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (x, w, b))
    (fused_mlp(tx, tw, tb, activation=act).float()
     * torch.from_numpy(ct)).sum().backward()
    for got, want, name in zip((tx.grad, tw.grad, tb.grad), ref,
                               ("dx", "dw", "db")):
        assert got.dtype == tdt, name
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   err_msg=name, **GRAD_TOL[dtype])


def test_backward_skips_what_needs_no_grad(monkeypatch):
    """A network's input layer: x needs no gradient, so its dgrad is never
    called, while dW and db are computed."""
    import repro_torch.kernels.fused_mlp.ops as ops
    x, w, b, _ = (torch.from_numpy(a) for a in _grad_inputs(4, 20, 8, 0))
    w.requires_grad_()
    b.requires_grad_()
    calls = []

    def spy(*args, **kw):
        calls.append(args)
        return fused_mlp_dgrad(*args, **kw)

    monkeypatch.setattr(ops, "fused_mlp_dgrad", spy)
    fused_mlp(x, w, b, activation="tanh").sum().backward()
    assert calls == [] and x.grad is None
    assert w.grad is not None and b.grad is not None
    x.requires_grad_()
    fused_mlp(x, w, b, activation="tanh").sum().backward()
    assert len(calls) == 1 and x.grad is not None


def _pad(a, rows, cols):
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_gradient_refs_match_pallas_kernels(act):
    """The plain dgrad and wgrad (the CPU path and the card's oracle)
    against the Pallas dgrad and wgrad kernels themselves, in interpret
    mode, on operands padded to the kernels' block multiples."""
    m, k, n = 8, 256, 128
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 200)).astype(np.float32)
    w = (rng.standard_normal((200, 100)) * 0.05).astype(np.float32)
    g = rng.standard_normal((5, 100)).astype(np.float32)
    pre = x @ w
    y = {"leaky_relu": np.where(pre >= 0, pre, 0.2 * pre),
         "relu": np.maximum(pre, 0), "tanh": np.tanh(pre),
         "linear": pre}[act].astype(np.float32)
    xp, wp, gp, yp = _pad(x, m, k), _pad(w, k, n), _pad(g, m, n), _pad(y, m, n)
    blocks = dict(block_m=m, block_n=n, block_k=128, interpret=True)
    dx_ref = fused_mlp_dgrad_layer(jnp.asarray(gp), jnp.asarray(yp),
                                   jnp.asarray(wp), activation=act, **blocks)
    dw_ref = fused_mlp_wgrad_layer(jnp.asarray(xp), jnp.asarray(gp),
                                   jnp.asarray(yp), activation=act, **blocks)
    tg, ty = torch.from_numpy(gp), torch.from_numpy(yp)
    dx = fused_mlp_dgrad(tg, ty, torch.from_numpy(wp), activation=act)
    dw, db = fused_mlp_wgrad(torch.from_numpy(xp), tg, ty, activation=act)
    assert torch.equal(dx, fused_mlp_dgrad_ref(tg, ty, torch.from_numpy(wp),
                                               act))
    ref_dw, ref_db = fused_mlp_wgrad_ref(torch.from_numpy(xp), tg, ty, act)
    assert torch.equal(dw, ref_dw) and torch.equal(db, ref_db)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref),
                               **GRAD_TOL["float32"])
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref),
                               **GRAD_TOL["float32"])
    # The bias gradient the wgrad also returns: the JAX package's XLA
    # reduction of g * act'(y) (ops.py's _fused_mlp_bwd_impl).
    from repro.kernels.fused_mlp.kernel import _activation_grad
    np.testing.assert_allclose(
        db.numpy(), np.asarray((gp * _activation_grad(jnp.asarray(yp), act,
                                                      0.2)).sum(0)),
        **GRAD_TOL["float32"])
    # The padding contributes nothing: the unpadded operands give the same
    # rows and columns.
    np.testing.assert_allclose(
        fused_mlp_dgrad_ref(torch.from_numpy(g), torch.from_numpy(y),
                            torch.from_numpy(w), act).numpy(),
        np.asarray(dx_ref)[:5, :200], **GRAD_TOL["float32"])


def test_gradient_wrappers_reject_what_the_kernels_do_not_take():
    g = torch.ones(4, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_mlp_dgrad(g, torch.ones(4, 7), torch.ones(16, 8))
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_mlp_wgrad(torch.ones(3, 16), g, g)
    with pytest.raises(TypeError, match="one dtype"):
        fused_mlp_wgrad(torch.ones(4, 16), g.double(), g)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp_dgrad(g, g, torch.ones(8, 16).t())
    with pytest.raises(ValueError, match="unknown activation"):
        fused_mlp_dgrad(g, g, torch.ones(16, 8), activation="gelu")


# The dgrad's shapes (M, K, N): the MLP step's 10 layers (M = 64), the
# attention step's encoder token layers (M up to 64 x 129) besides its DFP
# heads, and other M.
DGRAD_SHAPES = [(64, 4000, 1000), (64, 1000, 512), (64, 768, 512),
                (64, 128, 128), (64, 512, 12), (1, 4000, 1000),
                (128, 4000, 1000), (64, 512, 120), (8256, 64, 128),
                (8256, 128, 64), (8256, 64, 64), (8192, 64, 64),
                (8255, 128, 64), (16, 300, 129), (37, 300, 129), (5, 63, 7)]


@pytest.mark.parametrize("m,k,n", DGRAD_SHAPES)
def test_dgrad_split_plan_covers_n(m, k, n):
    """The dgrad's plan: a tile the kernel has, N cut into whole 32-column
    steps with no empty split, the splits of a tile one cluster of at most
    ``DGRAD_MAX_CLUSTER`` blocks, grid dimensions within CUDA's limits; N
    not split where the tiles reach half the SMs, else split as far as it
    takes to fill the card (or as far as the cluster and N allow)."""
    tile_m, tile_k, splits, chunk = kernel.dgrad_plan(m, k, n, sm_count=132)
    assert (tile_m, tile_k) in kernel.DGRAD_TILES
    assert chunk % kernel.DGRAD_STEP_N == 0
    assert (splits - 1) * chunk < n <= splits * chunk   # no empty split
    assert 1 <= splits <= kernel.DGRAD_MAX_CLUSTER
    m_tiles, k_tiles = -(-m // tile_m), -(-k // tile_k)
    assert m_tiles <= 65535 and k_tiles <= 65535
    most = min(kernel.DGRAD_MAX_CLUSTER, -(-n // kernel.DGRAD_STEP_N))
    if m_tiles * k_tiles >= 66:
        assert splits == 1
    else:
        assert m_tiles * k_tiles * splits >= min(132,
                                                 m_tiles * k_tiles * most)


# The attention encoder's token layers at M up to 64 x 129, and the DFP's
# layers at M = 64 (the minibatch) and beyond.
WGRAD_SHAPES = ([(m, k, n) for m in (8192, 8255, 8256)
                 for k, n in ((4, 64), (64, 64), (64, 128), (128, 64))]
                + [(64, 11410, 4000), (64, 4000, 1000), (64, 1000, 512),
                   (64, 768, 512), (64, 128, 128), (64, 2, 128),
                   (64, 512, 12), (1, 512, 120), (37, 300, 129),
                   (128, 4000, 1000), (1000, 63, 7)])


@pytest.mark.parametrize("m,k,n", WGRAD_SHAPES)
def test_wgrad_split_plan_covers_m(m, k, n):
    splits, chunk = kernel.wgrad_split_plan(m, k, n, sm_count=132)
    assert 1 <= splits <= 65535 and chunk % kernel.WGRAD_STEP_M == 0
    assert (splits - 1) * chunk < m <= splits * chunk   # no empty slice
    assert splits == 1 or chunk >= kernel.MIN_WGRAD_SPLIT_ROWS
    tile = kernel.wgrad_tile(m, k, n, sm_count=132)
    assert tile in kernel.WGRAD_TILES
    if m >= 8192:             # one or two tiles: M is what fills the card
        assert splits >= 64 and chunk == kernel.MIN_WGRAD_SPLIT_ROWS
    if -(-k // tile) * -(-n // tile) >= 132:
        assert splits == 1    # the tiles alone fill the card
