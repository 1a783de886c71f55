"""The port's ``generate(rules=...)`` (``repro_torch.launch.serve``) on a
(2, 4) ("data", "model") mesh of 8 spawned gloo ranks against the JAX
package's ``generate(rules=...)`` on a (2, 4) mesh of 8 host devices:
stablelm-1.6b's and deepseek-v2-lite-16b's smoke configs (MoE at a
capacity that drops nothing) under ``default_rules`` and ``serve_rules``
(whose caches split their positions over "model"), B = 2, prompts of 6,
8 new tokens, the reference's weights converted."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
import _torch_mesh
from repro.models import transformer as jtransformer
from repro_torch.convert import lm_params_from_jax
from test_torch_lm_decode import MARGIN, MODEL_TOL

ARCHS = {"stablelm-1.6b": 2, "deepseek-v2-lite-16b": 2}     # arch: seed
RULES = ("baseline", "serve")
PROMPT, NEW = 6, 8


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_serve")
    cases, ref_cases = {}, {}
    for i, (arch, seed) in enumerate(ARCHS.items()):
        cfg = _torch_mesh.dropless(arch)
        tree = jtransformer.init_params(jax.random.PRNGKey(seed),
                                        _jax_cfg(arch), jnp.float32)
        state = _torch_dist.as_numpy_state(lm_params_from_jax(
            jax.tree.map(np.asarray, tree), cfg, device="cpu"))
        prompts = np.random.default_rng(12 + i).integers(
            0, cfg.vocab_size, (2, PROMPT))
        path = str(root / f"prompts_{i}.npy")
        np.save(path, prompts)
        cases[arch] = (state, prompts)
        ref_cases[arch] = (seed, path)
    # The reference's process runs beside the ranks, and is waited for
    # (or killed at its time limit) whatever the ranks do.
    ref = _torch_mesh.reference_serve(ref_cases, NEW, str(root / "ref.npz"))
    os.makedirs(root / "ranks")
    try:
        got = _torch_dist.run_ranks(_torch_mesh.serve_world, root / "ranks",
                                    cases, NEW, timeout=400)
    finally:
        want = ref()
    return got, want


def _jax_cfg(arch):
    from dataclasses import replace
    from repro import configs as jconfigs
    cfg = jconfigs.smoke_config(arch)
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=16.0))
    return cfg


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_generate_under_rules_matches_the_reference(served, arch, rules):
    """The tokens equal the reference's under the same rules (every
    greedy step's top-2 margin in the reference's teacher-forced logits
    above ``MARGIN``), whole on the ranks (a plain tensor); the last
    decode step's logits within ``MODEL_TOL`` of the reference's decode
    step under those rules."""
    got, ref = served
    tokens = ref[arch, rules, "tokens"]
    logits = ref[arch, "forward"]
    top2 = np.sort(logits[:, PROMPT - 1:-1], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MARGIN
    mine = got[arch, rules]
    assert mine["plain"] and mine["tokens"].shape == (2, PROMPT + NEW)
    np.testing.assert_array_equal(mine["tokens"], tokens)
    np.testing.assert_allclose(mine["logits"], ref[arch, rules, "logits"],
                               **MODEL_TOL)


def test_reference_rule_sets_agree(served):
    """The reference's tokens are the same under both rule sets (the
    layout moves no token)."""
    _, ref = served
    for arch in ARCHS:
        np.testing.assert_array_equal(ref[arch, "baseline", "tokens"],
                                      ref[arch, "serve", "tokens"])
