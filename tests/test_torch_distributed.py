"""The port's multi-card layer against the JAX package's: the sharding
rules' spec tables at the production mesh shapes (no devices needed on
either side: an ``AbstractMesh``), and, on 8 spawned gloo CPU ranks on a
(2, 4) ("data", "model") mesh, ``tp_row_matmul`` and both of ``moe_apply``'s
expert-parallel paths (small T against the reference's no-mesh output,
big T, where each data shard drops its own choices, against the
reference's own sharded output from a JAX process with 8 host devices)."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_dist
from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.optim import OptConfig as JOptConfig
from repro.optim import opt_init as jopt_init
from repro_torch import configs as tconfigs
from repro_torch.convert import is_stacked, lm_tree_groups, params_from_jax
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import OptConfig as TOptConfig
from repro_torch.optim import opt_init as topt_init

MESHES = [(16, 16), (2, 16, 16)]
RULES = ["baseline", "opt", "serve"]


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _rules(shape, name):
    return (jsh.RULE_SETS[name](AbstractMesh(shape, _names(shape))),
            tsh.RULE_SETS[name](tsh.AbstractMesh(shape, _names(shape))))


def _flat_jax(tree) -> dict:
    """A tree of PartitionSpecs by dotted path -> tuples."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(leaf)
    return out


def _flat_torch(tree, prefix="") -> dict:
    if isinstance(tree, tsh.PartitionSpec):
        return {prefix[:-1]: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_torch(v, f"{prefix}{k}."))
    return out


def test_rules_resolve_like_the_reference():
    """Divisibility, combined axes and the leftmost-wins rule."""
    cases = [(("batch", "act_seq", "vocab"), (256, 4096, 256000)),
             (("batch", None, "heads", None), (32, 1, 8, 256)),
             (("experts", "fsdp", None), (64, 2048, 1408)),
             (("experts", "fsdp", None), (256, 7168, 2048)),
             (("vocab", "fsdp"), (32000, 4096)),
             (("batch", "kv_seq", "kv_heads", None), (1, 524288, 8, 128)),
             (("batch", None, None), (7, 3, 5))]
    for shape in MESHES:
        for name in RULES:
            jr, tr = _rules(shape, name)
            for axes, dims in cases:
                assert tuple(tr.spec(axes, dims)) == \
                    tuple(jr.spec(axes, dims)), (shape, name, axes, dims)
                assert tuple(tr.spec(axes)) == tuple(jr.spec(axes))


@pytest.fixture(scope="module")
def reference_shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jconfigs.get_config(arch)
            cache[arch] = jax.eval_shape(
                lambda: jtransformer.init_params(jax.random.PRNGKey(0), cfg,
                                                 jnp.bfloat16))
        return cache[arch]
    return get


def _opt_cfgs(cfg):
    big = cfg.param_count()[0] > 50e9
    return (JOptConfig(factored=big,
                       m_dtype=jnp.bfloat16 if big else jnp.float32),
            TOptConfig(factored=big,
                       m_dtype=torch.bfloat16 if big else torch.float32))


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_param_and_opt_specs_match_reference(arch, reference_shapes):
    """Every parameter's spec (full width and depth, built on the meta
    device; a stacked leaf's without its leading None) and the AdamW
    state's, at both production meshes under all three rule sets."""
    jshapes = reference_shapes(arch)
    lm = ttransformer.LM(tconfigs.get_config(arch), torch.bfloat16, "meta")
    groups = lm_tree_groups(lm)
    jopt, topt = _opt_cfgs(jconfigs.get_config(arch))
    oshapes = jax.eval_shape(lambda: jopt_init(jshapes, jopt))
    tstate = topt_init(lm, topt)
    for shape in MESHES:
        for name in RULES:
            jr, tr = _rules(shape, name)
            jspecs = jsh.param_pspecs(jshapes, jr)
            want = _flat_jax(jspecs)
            got = tsh.param_pspecs(lm, tr)
            assert set(want) == set(groups)
            for path, names in groups.items():
                spec = want[path]
                if is_stacked(path):
                    assert spec[0] is None
                    spec = spec[1:]
                for n in names:
                    assert tuple(got[n]) == spec, (shape, name, n)
            want_o = _flat_jax(jsteps.param_pspecs_for_opt(oshapes, jspecs))
            got_o = _flat_torch(tsteps.param_pspecs_for_opt(tstate, got))
            assert got_o == want_o, (shape, name)


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_batch_and_cache_specs_match_reference(arch):
    """``batch_pspec`` of every shape's inputs and ``cache_pspecs`` of the
    decode caches (the full config, decode_32k's batch and length)."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    shp = jconfigs.SHAPES["decode_32k"]
    jcache = jax.eval_shape(lambda: jtransformer.init_cache(
        jcfg, shp.global_batch, shp.seq_len, jnp.bfloat16))
    tcache = ttransformer.init_cache(tcfg, shp.global_batch, shp.seq_len,
                                     torch.bfloat16, device="meta")
    for shape in MESHES:
        for name in RULES:
            jr, tr = _rules(shape, name)
            for sname in jconfigs.SHAPE_ORDER:
                want = jsteps.batch_pspec(
                    jr, jpipe.input_specs(jcfg, jconfigs.SHAPES[sname]))
                got = tsteps.batch_pspec(
                    tr, tpipe.input_specs(tcfg, tconfigs.SHAPES[sname]))
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}
            assert _flat_torch(tsteps.cache_pspecs(tcache, tr)) == \
                _flat_jax(jsteps.cache_pspecs(jcache, jr)), (shape, name)


def test_input_specs_are_meta_tensors_of_make_batchs_layout():
    for arch in ("gemma-2b", "musicgen-medium", "internvl2-26b"):
        cfg = tconfigs.get_config(arch)
        for sname in tconfigs.SHAPE_ORDER:
            specs = tpipe.input_specs(cfg, tconfigs.SHAPES[sname])
            jspecs = jpipe.input_specs(jconfigs.get_config(arch),
                                       jconfigs.SHAPES[sname])
            assert set(specs) == set(jspecs)
            for k, t in specs.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(jspecs[k].shape)


# ----------------------------------------------------------- gloo ranks
D = 64


def _jax_moe_params():
    cfg = jconfigs.smoke_config("deepseek-v2-lite-16b").moe
    return cfg, jmoe.moe_init(jax.random.PRNGKey(0), D, cfg, True,
                              jnp.float32)


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    """The ranks' results and the inputs they were given."""
    cfg, jparams = _jax_moe_params()
    state = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jparams)).items()}
    rng = np.random.default_rng(0)
    inputs = dict(
        x_small=rng.standard_normal((2, 8, D)).astype(np.float32),
        # A direction shared by every token skews the routing, so experts
        # overflow their capacity and choices are dropped.
        x_big=(rng.standard_normal((4, 1100, D))
               + 2.0 * rng.standard_normal(D)).astype(np.float32),
        w_small=rng.standard_normal((2, 8, D)).astype(np.float32),
        h=rng.standard_normal((2, 16, 32)).astype(np.float32),
        w=(0.1 * rng.standard_normal((32, 24))).astype(np.float32),
        x_dropless=rng.standard_normal((2, 2080, D)).astype(np.float32),
        w_dropless=rng.standard_normal((2, 2080, D)).astype(np.float32))
    res = _torch_dist.run_ranks(
        _torch_dist.layer_checks, tmp_path_factory.mktemp("layers"), state,
        inputs["x_small"], inputs["x_big"], inputs["w_small"], inputs["h"],
        inputs["w"], inputs["x_dropless"], inputs["w_dropless"])
    return res, inputs, state, jparams


def test_tp_row_matmul_matches_plain_product(layers):
    res, inp, _, _ = layers
    y, placements, dh, dw = res["tp"]
    h, w = inp["h"], inp["w"]
    np.testing.assert_allclose(y, h @ w, rtol=1e-5, atol=1e-5)
    assert placements == "(Shard(dim=0), Shard(dim=1))"   # (B/data, S/model)
    ones = np.ones((2, 16, 24), np.float32)
    np.testing.assert_allclose(dh, ones @ w.T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw, np.einsum("bsf,bsd->fd", h, ones),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rules", ["default", "serve"])
def test_moe_small_t_matches_reference_without_a_mesh(layers, rules):
    """Tokens replicated, experts over "model" (fsdp slices summed over
    "data") or over ("model", "data") (a ``_StridedShard`` layout): the
    reference's no-mesh output, and the port's no-mesh gradients."""
    res, inp, state, jparams = layers
    cfg = jconfigs.smoke_config("deepseek-v2-lite-16b").moe
    got = res[f"small_{rules}"]
    want = jmoe.moe_apply(jparams, jnp.asarray(inp["x_small"]), cfg, "silu",
                          True)
    np.testing.assert_allclose(got["y"], np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    params = tmoe.MoE(D, cfg, True, torch.float32, "cpu")
    params.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params.requires_grad_(True)
    x = torch.from_numpy(inp["x_small"]).requires_grad_(True)
    (tmoe.moe_apply(params, x, cfg, "silu", True)
     * torch.from_numpy(inp["w_small"])).sum().backward()
    grads = {n: p.grad.numpy() for n, p in params.named_parameters()}
    grads["x"] = x.grad.numpy()
    assert set(got["grads"]) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=2e-4, atol=2e-4,
                                   err_msg=n)


def _reference_sharded_big_t(tmp_path, x):
    """The reference's ``moe_apply`` under its default rules on a (2, 4)
    mesh of 8 host devices, in a JAX process of its own."""
    np.save(tmp_path / "x.npy", x)
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import smoke_config
        from repro.distributed.compat import make_mesh
        from repro.distributed.sharding import default_rules, use_rules
        from repro.models.moe import moe_init, moe_apply
        cfg = smoke_config("deepseek-v2-lite-16b").moe
        params = moe_init(jax.random.PRNGKey(0), {D}, cfg, True, jnp.float32)
        x = jnp.asarray(np.load("{tmp_path / 'x.npy'}"))
        mesh = make_mesh((2, 4), ("data", "model"))
        with use_rules(default_rules(mesh)):
            out = jax.jit(lambda p, a: moe_apply(p, a, cfg, "silu", True))(
                params, x)
        np.save("{tmp_path / 'y.npy'}", np.asarray(out))
    """)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return np.load(tmp_path / "y.npy")


def test_moe_big_t_matches_reference_sharded(layers, tmp_path):
    """B * S = 4400 > SMALL_T_THRESHOLD: each data shard routes its own
    tokens at its own capacity and drops choices (asserted), so the
    result is the reference's sharded one, not its no-mesh one."""
    res, inp, state, _ = layers
    cfg = tconfigs.smoke_config("deepseek-v2-lite-16b").moe
    x = inp["x_big"]
    assert x.shape[0] * x.shape[1] > tmoe.SMALL_T_THRESHOLD
    params = tmoe.MoE(D, cfg, True, torch.float32, "cpu")
    params.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    dropped = 0
    for half in np.split(x, 2):                  # the two data shards
        xt = torch.from_numpy(half).reshape(-1, D)
        _, idx = tmoe.route(params.router, xt, cfg)
        pos = tmoe._positions_in_expert(idx, cfg.n_routed)
        dropped += int((pos >= tmoe._default_capacity(len(xt), cfg)).sum())
    assert dropped > 0
    want = _reference_sharded_big_t(tmp_path, x)
    np.testing.assert_allclose(res["big"]["y"], want, rtol=2e-4, atol=2e-4)


def test_moe_big_t_gradients_match_without_a_mesh(layers):
    """At a capacity where no choice drops (asserted), the big-T path's
    output and its gradients (tokens, router, experts, shared experts)
    equal the no-mesh layer's: the collectives' gradients add up."""
    from dataclasses import replace
    res, inp, state, _ = layers
    cfg = replace(tconfigs.smoke_config("deepseek-v2-lite-16b").moe,
                  capacity_factor=_torch_dist.DROPLESS)
    x = inp["x_dropless"]
    assert x.shape[0] * x.shape[1] > tmoe.SMALL_T_THRESHOLD
    params = tmoe.MoE(D, cfg, True, torch.float32, "cpu")
    params.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    for half in np.split(x, 2):                  # the two data shards
        xt = torch.from_numpy(half).reshape(-1, D)
        _, idx = tmoe.route(params.router, xt, cfg)
        pos = tmoe._positions_in_expert(idx, cfg.n_routed)
        assert int(pos.max()) < tmoe._default_capacity(len(xt), cfg)
    params.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tmoe.moe_apply(params, xt, cfg, "silu", True)
    (y * torch.from_numpy(inp["w_dropless"])).sum().backward()
    got = res["big_dropless"]
    np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=2e-4,
                               atol=2e-4)
    grads = {n: p.grad.numpy() for n, p in params.named_parameters()}
    grads["x"] = xt.grad.numpy()
    assert set(got["grads"]) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=2e-4, atol=2e-3,
                                   err_msg=n)
