"""Rank bodies of the tests that hold the port's LM entry points on a mesh
(``tests/test_torch_launch_mesh*.py``) against the JAX package's, and the
JAX processes with host devices that give the reference's side.  The
bodies run on spawned gloo ranks (``_torch_dist.run_ranks``); this module
imports torch only at its top, so each rank starts quickly."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch
import torch.distributed as dist

ARCH = "stablelm-1.6b"
SEQ, BATCH = 32, 8              # B over 8 "data" ranks: one row each
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def shape():
    from repro_torch.configs import InputShape
    return InputShape("t", SEQ, BATCH, "train")


def _gathered(value):
    """Every rank's ``value``, in rank order (on every rank)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _full(x) -> np.ndarray:
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _flat_specs(tree, prefix="") -> dict:
    """Dotted path -> spec of a tree of ``PartitionSpec`` (a tuple that
    is a leaf)."""
    from repro_torch.distributed.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}{k}."))
    return out


def _mesh(shape_):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape_, mesh_dim_names=("data", "model"))


def _run_summary(run) -> dict:
    return {"losses": run.losses, "steps": run.steps,
            "restored_from": run.restored_from}


# --------------------------------------------------------------- training
def train_world(rank, dirs, init_archs):
    """``train_loop`` resumed from each of ``dirs`` to step 4: "host"
    with ``mesh=None`` (the host mesh of the initialised group, (8, 1)),
    "4x2" on a (4, 2) ("data", "model") mesh passed as ``mesh=``; then,
    for each of ``init_archs``, ``init_sharded_params`` on the (2, 4)
    mesh against ``init_params`` on the CPU and ``lm_params_to_tree``/
    ``load_lm_tree`` on its DTensors (``_init_case``)."""
    from repro_torch import configs
    from repro_torch.launch.train import train_loop
    out = {}
    for name, mesh in (("host", None), ("4x2", _mesh((4, 2)))):
        run = train_loop(configs.smoke_config(ARCH), shape(), steps=4,
                         ckpt_dir=dirs[name], ckpt_every=2, log_every=1,
                         mesh=mesh)
        out["train", name] = _gathered(_run_summary(run))
    for arch in init_archs:
        out["init", arch] = _init_case(arch)
    return out


def _init_case(arch) -> dict:
    """On the (2, 4) mesh under ``default_rules``: whether each parameter
    of ``init_sharded_params`` is bit-equal to ``init_params``'s (both
    from a CPU generator seeded 3) and laid out by ``param_pspecs``; the
    layouts of ``lm_params_to_tree``'s leaves against
    ``param_tree_pspecs`` and their local shapes; and whether
    ``load_lm_tree`` of that tree into a sharded model of other weights
    gives the first model's weights back, each parameter keeping its
    layout."""
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.convert import _flatten, lm_params_to_tree, load_lm_tree
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = configs.smoke_config(arch)
    mesh = _mesh((2, 4))
    rules = sh.default_rules(mesh)

    def gen(seed):
        return torch.Generator("cpu").manual_seed(seed)

    lm = steps.init_sharded_params(cfg, rules, generator=gen(3),
                                   dtype=torch.float32)
    plain = transformer.init_params(cfg, generator=gen(3), device="cpu",
                                    dtype=torch.float32)
    pspecs = sh.param_pspecs(lm, rules)
    want = dict(plain.named_parameters())
    res = {"equal": {}, "laid_out": {}}
    for n, p in lm.named_parameters():
        res["equal"][n] = torch.equal(p.full_tensor(), want[n].detach())
        res["laid_out"][n] = tuple(p.placements) == sh.placements(pspecs[n],
                                                                  mesh)
    tree = lm_params_to_tree(lm)
    flat = {}
    _flatten(tree, "", flat, leaf=lambda t: t)
    specs = _flat_specs(steps.param_tree_pspecs(lm, pspecs))
    res["tree"] = {
        path: {"dtensor": isinstance(t, DTensor),
               "laid_out": isinstance(t, DTensor) and tuple(t.placements)
               == sh.placements(specs[path], mesh),
               "local": tuple(t.to_local().shape) if isinstance(t, DTensor)
               else None,
               "global": tuple(t.shape)}
        for path, t in flat.items()}
    other = steps.init_sharded_params(cfg, rules, generator=gen(4),
                                      dtype=torch.float32)
    load_lm_tree(other, tree)
    got = dict(other.named_parameters())
    res["loaded"] = {
        n: isinstance(got[n], DTensor)
        and tuple(got[n].placements) == tuple(p.placements)
        and torch.equal(got[n].full_tensor(), p.full_tensor())
        for n, p in lm.named_parameters()}
    return res


# ------------------------------------------------------------ checkpoints
def save_world(rank, train_dir, manager_dir):
    """8 ranks: ``train_loop`` to step 2 on the host mesh (its checkpoint
    of step 2 written by ``save_async``); then a ``CheckpointManager`` of
    a small DTensor tree: ``save`` of step 1, ``save_async`` of step 2,
    ``wait()``, and each rank's ``latest_step`` right after its
    ``wait()``.  Returns the run, every rank's latest step and the whole
    tree."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.train import train_loop
    run = train_loop(configs.smoke_config(ARCH), shape(), steps=2,
                     ckpt_dir=train_dir, ckpt_every=2, log_every=1)
    mesh = _mesh((2, 4))
    g = torch.Generator().manual_seed(5)
    tree = {"a": torch.randn(8, 12, generator=g),
            "b": [torch.randn(4, 6, generator=g).to(torch.bfloat16)],
            "n": torch.arange(16, dtype=torch.int32)}
    specs = {"a": sh.P("data", "model"), "b": [sh.P(None, ("data",
                                                          "model"))],
             "n": sh.P("model")}
    placed = sh.distribute_tree(tree, specs, mesh)
    manager = CheckpointManager(manager_dir)
    manager.save(placed, 1)
    manager.save_async(placed, 2)
    manager.wait()
    return {"run": _run_summary(run),
            "latest": _gathered(latest_step(manager_dir)),
            "tree": {"a": tree["a"].numpy(),
                     "b": tree["b"][0].float().numpy(),
                     "n": tree["n"].numpy()}}


def restore_world(rank, dirs):
    """4 ranks: each of ``dirs`` (a ``train_loop`` checkpoint of step 2)
    restored with ``shardings=`` of the host mesh's specs under
    ``default_rules`` into a template of meta tensors; returns per leaf
    path the whole array, whether it is a DTensor laid out by its spec,
    and its local shape."""
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.convert import _flatten, lm_params_to_tree
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import make_host_mesh, steps
    from repro_torch.models import transformer
    from repro_torch.optim import OptConfig, opt_init
    cfg = configs.smoke_config(ARCH)
    mesh = make_host_mesh()
    rules = sh.default_rules(mesh)
    lm = transformer.LM(cfg, torch.float32, "meta")
    pspecs = sh.param_pspecs(lm, rules)
    opt = opt_init(lm, OptConfig(lr=1e-3, weight_decay=0.0), "meta")
    template = {"params": lm_params_to_tree(lm), "opt": opt}
    specs = {"params": steps.param_tree_pspecs(lm, pspecs),
             "opt": steps.param_pspecs_for_opt(opt, pspecs)}
    flat_specs = _flat_specs(specs)
    out = {}
    for name, d in dirs.items():
        tree, manifest = restore_pytree(template, d,
                                        shardings=sh.named_shardings(specs,
                                                                     mesh))
        flat = {}
        _flatten(tree, "", flat, leaf=lambda t: t)
        out[name] = {
            path: {"array": _full(t),
                   "laid_out": isinstance(t, DTensor) and tuple(
                       t.placements) == sh.placements(flat_specs[path], mesh),
                   "sharded": isinstance(t, DTensor)
                   and tuple(t.to_local().shape) != tuple(t.shape),
                   "dtype": str(t.dtype)}
            for path, t in flat.items()}
        out[name, "step"] = manifest["step"]
    return out


def sigterm_world(rank, directory, signalled):
    """``train_loop`` of 100,000 steps with no periodic checkpoint; rank
    ``signalled`` sends itself a SIGTERM while making step 2's batch.
    Returns every rank's run."""
    import signal
    from repro_torch import configs
    from repro_torch.launch import train
    make_batch = train.make_batch

    def batch_then_signal(cfg, shape_, step, *a, **k):
        if rank == signalled and step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return make_batch(cfg, shape_, step, *a, **k)

    train.make_batch = batch_then_signal
    try:
        run = train.train_loop(configs.smoke_config(ARCH), shape(),
                               steps=100_000, ckpt_dir=directory,
                               ckpt_every=100_000, log_every=1)
    finally:
        train.make_batch = make_batch
    return _gathered(_run_summary(run))


# ---------------------------------------------------------------- serving
def serve_world(rank, cases, new_tokens):
    """On the (2, 4) mesh, for each ``cases`` arch ({arch: (numpy state of
    the reference's weights, prompts)}; MoE dropless) under
    ``default_rules`` and ``serve_rules``: ``generate(rules=...)`` of
    ``new_tokens`` from the placed weights; returns the tokens and the
    last decode step's logits, recorded from the step ``generate``
    runs."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import serve
    from _torch_dist import _lm, _place
    mesh = _mesh((2, 4))
    out = {}
    make_decode_step = serve.make_decode_step
    for arch, (state, prompts) in cases.items():
        cfg = dropless(arch)
        for name in ("baseline", "serve"):
            rules = sh.RULE_SETS[name](mesh)
            params = _lm(cfg, state)
            _place(params, rules)
            seen = []

            def recording(cfg_):
                step = make_decode_step(cfg_)

                def inner(*a):
                    logits, cache = step(*a)
                    seen.append(logits)
                    return logits, cache
                return inner

            serve.make_decode_step = recording
            try:
                res = serve.generate(cfg, params, torch.from_numpy(prompts),
                                     max_new_tokens=new_tokens, rules=rules)
            finally:
                serve.make_decode_step = make_decode_step
            out[arch, name] = {"tokens": res["tokens"].numpy(),
                               "plain": type(res["tokens"]) is torch.Tensor,
                               "logits": _full(seen[-1])}
    return out


def dropless(arch):
    """``arch``'s smoke config; an MoE at a capacity that drops nothing."""
    from dataclasses import replace
    from repro_torch import configs
    cfg = configs.smoke_config(arch)
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=16.0))
    return cfg


# ------------------------------------------------ the reference's processes
def start_reference(code: str, devices: int) -> subprocess.Popen:
    """``code`` started in a JAX process of its own with ``devices`` host
    devices (on the CPU); ``finish`` waits for it."""
    head = (f"import os\nos.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={devices}'\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", head + textwrap.dedent(code)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def finish(proc: subprocess.Popen, timeout: int = 300) -> None:
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]


def run_reference(code: str, devices: int, timeout: int = 300) -> None:
    """``code`` in a JAX process of its own with ``devices`` host devices
    (on the CPU)."""
    finish(start_reference(code, devices), timeout)


def reference_train(directory: str, steps: int, out: str) -> dict:
    """The reference's ``train_loop`` on 8 host devices (its host mesh,
    (8, 1)) to ``steps``, checkpoints every 2 steps; its run as a dict."""
    run_reference(f"""
        import json
        from repro import configs
        from repro.launch.train import train_loop
        run = train_loop(configs.smoke_config({ARCH!r}),
                         configs.InputShape("t", {SEQ}, {BATCH}, "train"),
                         steps={steps}, ckpt_dir={directory!r}, ckpt_every=2,
                         log_every=1)
        with open({out!r}, "w") as f:
            json.dump({{"losses": run.losses, "steps": run.steps,
                       "restored_from": run.restored_from}}, f)
    """, 8)
    with open(out) as f:
        return json.load(f)


def reference_restore(directory: str, out: str) -> dict:
    """The reference's ``restore_pytree(shardings=)`` of a train
    checkpoint (``{"params", "opt"}``) on 4 host devices, onto its host
    mesh's specs under ``default_rules``: per leaf path (dotted) the
    array, its spec and whether its first shard is smaller than it."""
    run_reference(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro import configs
        from repro.checkpoint.store import restore_pytree
        from repro.distributed.sharding import default_rules, param_pspecs
        from repro.launch.mesh import make_host_mesh
        from repro.launch.steps import param_pspecs_for_opt
        from repro.models import transformer
        from repro.optim import OptConfig, opt_init
        cfg = configs.smoke_config({ARCH!r})
        opt = OptConfig(lr=1e-3, weight_decay=0.0)
        shapes = jax.eval_shape(lambda: (lambda p: {{
            "params": p, "opt": opt_init(p, opt)}})(transformer.init_params(
                jax.random.PRNGKey(0), cfg, jnp.float32)))
        mesh = make_host_mesh()
        assert mesh.devices.size == 4
        rules = default_rules(mesh)
        pspecs = param_pspecs(shapes["params"], rules)
        specs = {{"params": pspecs,
                  "opt": param_pspecs_for_opt(shapes["opt"], pspecs)}}
        shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                 is_leaf=lambda x: isinstance(x, P))
        tree, manifest = restore_pytree(shapes, {directory!r},
                                        shardings=shardings)
        arrays, specs_out, split = {{}}, {{}}, {{}}
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            arrays[key] = np.asarray(x)
            specs_out[key] = repr(tuple(x.sharding.spec))
            split[key] = x.addressable_shards[0].data.shape != x.shape
        np.savez({out!r}, **arrays)
        import json
        with open({out!r} + ".json", "w") as f:
            json.dump({{"specs": specs_out, "split": split,
                       "step": manifest["step"]}}, f)
    """, 4)
    with np.load(out) as data:
        arrays = {k: data[k] for k in data.files}
    with open(out + ".json") as f:
        meta = json.load(f)
    return {"arrays": arrays, **meta}


def reference_serve(cases: dict, new_tokens: int, out: str):
    """The reference's ``generate(rules=...)`` on a (2, 4) mesh of 8 host
    devices under ``default_rules`` and ``serve_rules`` for each
    ``cases`` arch ({arch: (seed, prompts path)}; MoE dropless), the last
    step's logits from its decode step run over the generated tokens
    under the same rules, and the teacher-forced forward's logits (no
    mesh) for the top-2 margins, started in the background.  Returns a
    function that waits for the process and reads them (keyed (arch,
    rules, "tokens" | "logits") and (arch, "forward"))."""
    proc = start_reference(f"""
        from dataclasses import replace
        import jax, jax.numpy as jnp, numpy as np
        from repro import configs
        from repro.distributed.compat import make_mesh
        from repro.distributed.sharding import RULE_SETS
        from repro.launch.serve import generate
        from repro.launch.steps import _bind_rules, make_decode_step
        from repro.models import transformer
        mesh = make_mesh((2, 4), ("data", "model"))
        res = {{}}
        for arch, (seed, path) in {cases!r}.items():
            cfg = configs.smoke_config(arch)
            if cfg.moe is not None:
                cfg = replace(cfg, moe=replace(cfg.moe,
                                               capacity_factor=16.0))
            params = transformer.init_params(jax.random.PRNGKey(seed), cfg,
                                             jnp.float32)
            prompts = jnp.asarray(np.load(path), jnp.int32)
            for name in ("baseline", "serve"):
                rules = RULE_SETS[name](mesh)
                tokens = generate(cfg, params, prompts,
                                  max_new_tokens={new_tokens},
                                  rules=rules)["tokens"]
                step = jax.jit(_bind_rules(make_decode_step(cfg), rules))
                B, S = tokens.shape
                cache = transformer.init_cache(cfg, B, S, jnp.float32)
                for pos in range(S):
                    logits, cache = step(params,
                                         {{"tokens": tokens[:, pos:pos + 1]}},
                                         cache, jnp.int32(pos))
                res[f"{{arch}}|{{name}}|tokens"] = np.asarray(tokens)
                res[f"{{arch}}|{{name}}|logits"] = np.asarray(logits)
            res[f"{{arch}}|forward"] = np.asarray(jax.jit(
                lambda p, t: transformer.forward(p, cfg, {{"tokens": t}}))(
                    params, tokens))
        np.savez({out!r}, **res)
    """, 8)

    def result() -> dict:
        finish(proc)
        with np.load(out) as data:
            return {tuple(k.split("|")): data[k] for k in data.files}
    return result
