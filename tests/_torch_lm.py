"""Shared helpers of the tests that hold the port's LM training
(``repro_torch.optim``, ``models.transformer.loss``, ``launch.steps``,
``launch.train``) against the JAX package's: reference weights converted
into an ``LM``, trees of either package flattened to dotted paths, and
the port's per-layer gradients stacked into the reference's layout."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.configs import InputShape
from repro_torch.convert import (_flatten, is_stacked, lm_params_from_jax,
                                 lm_tree_groups, nest)
from repro_torch.data import pipeline


def numpy_leaf(x) -> np.ndarray:
    """A leaf of either package as a float32 (or integer) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def flat(tree) -> dict:
    """Dotted path -> numpy array, for a tree of either package."""
    out = {}
    _flatten(tree, "", out, leaf=numpy_leaf)
    return out


def dtypes(tree) -> dict:
    """Dotted path -> dtype name (``"bfloat16"``, ``"int32"``)."""
    out = {}
    _flatten(tree, "", out, leaf=lambda x: str(x.dtype).removeprefix(
        "torch."))
    return out


def reference(arch: str, seed: int = 0):
    """(reference config, port config, reference float32 params, the same
    weights as a port ``LM`` on the CPU) of ``arch``'s smoke config."""
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    tree = jtransformer.init_params(jax.random.PRNGKey(seed), jcfg,
                                    jnp.float32)
    return jcfg, cfg, tree, lm_params_from_jax(
        jax.tree.map(np.asarray, tree), cfg, device="cpu")


def batches(jcfg, cfg, seq: int = 64, batch: int = 2, step: int = 0):
    """The same train batch from both packages' ``make_batch``."""
    shape = InputShape("t", seq, batch, "train")
    return (jpipeline.make_batch(jcfg, jconfigs.InputShape(
        "t", seq, batch, "train"), step, jpipeline.DataConfig(seed=0),
        jnp.float32),
        pipeline.make_batch(cfg, shape, step, device="cpu"))


def stacked(lm, by_name: dict) -> dict:
    """Per-parameter tensors of ``lm`` (keyed by parameter name, such as
    gradients) in the reference's stacked tree."""
    return nest({path: torch.stack([by_name[n] for n in names])
                 if is_stacked(path) else by_name[names[0]]
                 for path, names in lm_tree_groups(lm).items()})
