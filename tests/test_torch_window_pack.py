"""The port's window pack (``repro_torch.kernels.window_pack``) on the CPU
against the JAX package's Pallas kernel in interpret mode and its plain
reference: the same inputs, made with numpy from a seed, give exactly the
same packed window."""
import numpy as np
import pytest
import torch

from repro.kernels.window_pack.ops import pack_window as jax_pack_window
from repro_torch.kernels.window_pack import (pack_window,
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
