"""The port's fused dense layer against the JAX package's fused-MLP kernel
(Pallas, interpret mode on the CPU, as tests/test_kernels.py runs it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_mlp.ops import fused_mlp as jax_fused_mlp
from repro_torch.kernels.fused_mlp import fused_mlp, kernel
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
    with pytest.raises(RuntimeError, match="no_grad"):
        fused_mlp(x, w.requires_grad_(), b)


@pytest.mark.parametrize("m,k,n", [(1, 11410, 4000), (16, 11410, 4000),
                                   (16, 4000, 1000), (16, 1000, 512),
                                   (16, 2, 128), (37, 512, 120), (16, 63, 12)])
def test_split_plan_covers_k(m, k, n):
    splits, chunk = kernel.split_plan(m, k, n, sm_count=132)
    assert 1 <= splits <= 65535
    assert (splits - 1) * chunk < k <= splits * chunk   # no empty split
    assert splits == 1 or chunk >= kernel.MIN_SPLIT_ROWS
