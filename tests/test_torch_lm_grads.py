"""The port's LM loss and its gradients (``models.transformer.loss`` on the
``"torch"`` backend, the training path) against the JAX package's, for the
smoke config of every architecture: the loss, and every gradient leaf
mapped through the reference's stacked layout; remat on and off give
bit-equal gradients.  Inputs come from both packages' ``make_batch``
(the same numbers); weights from the reference, converted; float32.  The
reference's calls are jitted."""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_lm import batches, flat, reference, stacked
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.models import transformer

# The reference tests' own gradient tolerances (tests/test_kernels.py:15).
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _jit_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss(p, jcfg, b)))


def _port_grads(lm, cfg, batch, remat: bool):
    lm.requires_grad_(True)
    loss = transformer.loss(lm, cfg, batch, remat=remat)
    named = list(lm.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return loss, {n: torch.zeros_like(p) if g is None else g
                  for (n, p), g in zip(named, grads)}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_loss_and_gradients_match_reference(arch):
    """B = 2, S = 64: the loss within 2e-4 and every gradient leaf, the
    port's per-layer gradients stacked, within the reference's gradient
    tolerance (a leaf the loss does not reach gets zeros in both).  Remat
    recomputes the same operations, so its gradients equal the plain
    backward's bit for bit (the MoE routing included)."""
    jcfg, cfg, tree, lm = reference(arch)
    jbatch, batch = batches(jcfg, cfg)
    jloss, jgrads = _jit_value_and_grad(jcfg)(tree, jbatch)
    loss, grads = _port_grads(lm, cfg, batch, remat=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    got, want = flat(stacked(lm, grads)), flat(jgrads)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].shape == want[path].shape, path
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **GRAD_TOL)
    loss_plain, plain = _port_grads(lm, cfg, batch, remat=False)
    assert torch.equal(loss_plain, loss)
    for n, g in grads.items():
        assert torch.equal(plain[n], g), n
