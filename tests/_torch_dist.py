"""Multi-rank helpers of the port's distribution tests: ``run_ranks``
spawns CPU ranks on gloo (a ``FileStore`` under the test's temporary
directory, so concurrent test workers never share a port) and returns what
rank 0's function returned; the functions below are the ranks' bodies.
This module imports torch only, so each spawned rank starts quickly."""
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESH = (2, 4)                    # ("data", "model"), 8 ranks
DROPLESS = 8.0                   # a capacity factor at which no choice drops


def _entry(rank, world, store_path, fn, args, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        res = fn(rank, *args)
        if rank == 0:
            torch.save(res, out_path)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, tmp_path, *args, world: int = 8, timeout=None):
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks -> rank 0's
    result.  With ``timeout`` (seconds) ranks still running then are
    killed and ``TimeoutError`` is raised: a world where one rank waits
    in a collective that another skipped ends instead of hanging."""
    import time
    store = os.path.join(str(tmp_path), "store")
    out = os.path.join(str(tmp_path), "rank0.pt")
    ctx = mp.start_processes(_entry, args=(world, store, fn, args, out),
                             nprocs=world, start_method="spawn", join=False)
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{fn.__name__} on {world} ranks ran past "
                               f"{timeout} s")
    return torch.load(out, weights_only=False)


def _mesh(shape=MESH):
    """A ("data", "model") mesh, or ("pod", "data", "model") of 3 dims."""
    from torch.distributed.device_mesh import init_device_mesh
    names = ("pod", "data", "model")[-len(shape):]
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _lm(cfg, state):
    """The smoke ``LM`` of ``cfg`` from ``state``, float32 on the CPU."""
    from repro_torch.models import transformer
    params = transformer.LM(cfg, torch.float32, "cpu")
    params.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return params


def _place(params, rules):
    """``params`` as DTensors laid out by ``rules``; returns their specs."""
    from repro_torch.distributed import sharding as sh
    pspecs = sh.param_pspecs(params, rules)
    sh.distribute_params(params, rules, pspecs)
    return pspecs


def _inputs(batch, rules):
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    return sh.distribute_tree(b, steps.batch_pspec(rules, b), rules.mesh)


def layer_checks(rank, state, x_small, x_big, w_small, h, w, x_dropless,
                 w_dropless):
    """tp_row_matmul, and moe_apply on both mesh paths with their
    gradients (the big-T path's at a capacity that drops nothing), on the
    (2, 4) mesh; returns the gathered outputs."""
    from dataclasses import replace
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe
    mesh = _mesh()
    cfg = smoke_config("deepseek-v2-lite-16b").moe
    out = {}

    # The row-parallel product under sequence parallelism (act_seq over
    # model), with its gradients.
    rules = sh.Rules(mapping=dict(batch=("data",), act_seq=("model",),
                                  mlp=("model",), fsdp=("data",)), mesh=mesh)
    hd = distribute_tensor(torch.from_numpy(h), mesh,
                           sh.placements(sh.P("data", None, "model"), mesh)
                           ).requires_grad_(True)
    wd = distribute_tensor(torch.from_numpy(w), mesh,
                           sh.placements(sh.P("model", None), mesh)
                           ).requires_grad_(True)
    with sh.use_rules(rules):
        y = sh.tp_row_matmul(hd, wd)
        y.sum().backward()
    out["tp"] = (y.full_tensor().detach().numpy(), str(y.placements),
                 hd.grad.full_tensor().numpy(), wd.grad.full_tensor().numpy())

    def moe_case(rules, x, grad, wt=w_small, cfg=cfg):
        params = moe.MoE(64, cfg, True, torch.float32, "cpu")
        params.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state.items()})
        params.requires_grad_(grad)
        sh.distribute_params(params, rules,
                             sh.param_pspecs(params, rules, "stack/moe/"))
        xd = distribute_tensor(
            torch.from_numpy(x), mesh,
            sh.placements(rules.spec(("batch", None, None), x.shape), mesh)
        ).requires_grad_(grad)
        with sh.use_rules(rules):
            y = moe.moe_apply(params, xd, cfg, "silu", True)
            res = {"y": y.full_tensor().detach().numpy()}
            if grad:
                wt = distribute_tensor(torch.from_numpy(wt), mesh,
                                       y.placements)
                (y * wt).sum().backward()
                res["grads"] = {n: p.grad.full_tensor().numpy()
                                for n, p in params.named_parameters()}
                res["grads"]["x"] = xd.grad.full_tensor().numpy()
        return res

    out["small_default"] = moe_case(sh.default_rules(mesh), x_small, True)
    out["small_serve"] = moe_case(sh.serve_rules(mesh), x_small, True)
    out["big"] = moe_case(sh.default_rules(mesh), x_big, False)
    out["big_dropless"] = moe_case(
        sh.default_rules(mesh), x_dropless, True, w_dropless,
        replace(cfg, capacity_factor=DROPLESS))
    return out


def train_step(rank, arch, batch, state):
    """One ``make_train_step`` of a smoke config under ``default_rules``
    on the (2, 4) mesh, from the weights ``state`` (the reference's, by
    ``convert``); returns the loss, grad norm, new parameters and the
    AdamW state's leaves by dotted path."""
    from repro_torch.distributed import sharding as sh
    return _train_case(arch, batch, state, sh.default_rules(_mesh()))


def _train_case(arch, batch, state, rules):
    """One ``make_train_step`` of ``arch``'s smoke config under ``rules``
    (``train_step``'s result)."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import _flatten
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.optim import OptConfig, opt_init
    cfg = smoke_config(arch)
    opt = OptConfig(lr=1e-3, weight_decay=0.0)
    params = _lm(cfg, state)
    st = opt_init(params, opt)
    pspecs = _place(params, rules)
    st = sh.distribute_tree(st, steps.param_pspecs_for_opt(st, pspecs),
                            rules.mesh)
    step = steps._bind_rules(steps.make_train_step(cfg, opt), rules)
    params, st, m = step(params, st, _inputs(batch, rules))
    opt_leaves = {}
    _flatten(st["leaves"], "leaves.", opt_leaves,
             leaf=lambda x: x.full_tensor().detach().float().numpy())
    return {"opt": opt_leaves,
            "loss": float(m["loss"].full_tensor()),
            "grad_norm": float(m["grad_norm"].full_tensor()),
            "params": {n: p.full_tensor().detach().numpy()
                       for n, p in params.named_parameters()},
            "placements": {n: str(p.placements)
                           for n, p in params.named_parameters()},
            "step": int(st["step"].full_tensor()
                        if hasattr(st["step"], "full_tensor")
                        else st["step"])}


def _thread_grads(arch, batch, state, rules):
    """The gradients of ``arch``'s loss (remat) under ``rules``, by name:
    ``"here"`` with the backward in the calling thread under the rules, as
    ``make_train_step`` runs it on the CPU, and ``"thread"`` with the
    backward in a thread of its own, as autograd runs a card's backward:
    there no rules are installed, and DTensor's implicit replication is
    off where a torch release keeps it per thread.  An error there is
    returned as its text."""
    import threading
    import traceback
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer
    cfg = smoke_config(arch)
    params = _lm(cfg, state)
    _place(params, rules)
    params.requires_grad_(True)
    names, leaves = zip(*params.named_parameters())
    b = _inputs(batch, rules)

    def grads(in_thread: bool):
        with sh.use_rules(rules):
            loss = transformer.loss(params, cfg, b, remat=True)
            if not in_thread:
                return torch.autograd.grad(loss, leaves, allow_unused=True)
        got = []

        def backward():
            try:
                got.append(torch.autograd.grad(loss, leaves,
                                               allow_unused=True))
            except Exception:
                got.append(traceback.format_exc(limit=-3))

        t = threading.Thread(target=backward, daemon=True)
        t.start()
        t.join(timeout=600)
        return got[0] if got else "the backward ran past 600 s"

    out = {}
    for key, in_thread in (("here", False), ("thread", True)):
        g = grads(in_thread)
        out[key] = g if isinstance(g, str) else {
            n: None if x is None else x.full_tensor().numpy()
            for n, x in zip(names, g)}
    return out


def seq_parallel(rank, train, prefill, decode):
    """The sequence-parallel rule sets (act_seq and kv_seq over "model") on
    the (2, 4) mesh, every case in one world: for each ``train`` arch
    ({arch: (batch, state)}) one train step under "opt" and under "serve"
    (``_train_case``'s result), and mamba2-1.3b's under the baseline rules
    on a (2, 2, 2) ("pod", "data", "model") mesh, whose one row a (pod,
    data) shard holds, and the gradients under "opt" with the backward in
    the calling thread and in another (``_thread_grads``); for each
    ``prefill`` arch ({arch: (tokens, state)}) the prefill step's last
    logits under both; for each ``decode`` arch ({arch: (tokens (B, n),
    filled cache, pos, state)}) n decode steps from pos under "serve" (the
    cache's positions over "model"), their logits and the cache after them."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import _flatten, nest
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    mesh = _mesh()
    out = {}
    for arch, (batch, state) in train.items():
        for name in ("opt", "serve"):
            out["train", arch, name] = _train_case(
                arch, batch, state, sh.RULE_SETS[name](mesh))
    if "mamba2-1.3b" in train:
        out["train", "mamba2-1.3b", "pod"] = _train_case(
            "mamba2-1.3b", *train["mamba2-1.3b"],
            sh.default_rules(_mesh((2, 2, 2))))
    for arch, (batch, state) in train.items():
        out["thread", arch, "opt"] = _thread_grads(
            arch, batch, state, sh.optimized_rules(mesh))
    for arch, (tokens, state) in prefill.items():
        cfg = smoke_config(arch)
        for name in ("opt", "serve"):
            rules = sh.RULE_SETS[name](mesh)
            params = _lm(cfg, state)
            _place(params, rules)
            step = steps._bind_rules(
                steps.make_prefill_step(cfg, backend="torch"), rules)
            out["prefill", arch, name] = step(
                params, _inputs({"tokens": tokens}, rules)).full_tensor(
                ).numpy()
    for arch, (tokens, cache, pos, state) in decode.items():
        cfg = smoke_config(arch)
        rules = sh.serve_rules(mesh)
        params = _lm(cfg, state)
        _place(params, rules)
        tree = nest({k: torch.from_numpy(v) for k, v in cache.items()})
        tree = sh.distribute_tree(tree, steps.cache_pspecs(tree, rules), mesh)
        step = steps._bind_rules(steps.make_decode_step(cfg), rules)
        logits = []
        for i in range(tokens.shape[1]):
            got, tree = step(params, _inputs({"tokens": tokens[:, i:i + 1]},
                                             rules), tree, pos + i)
            logits.append(got.full_tensor().numpy())
        flat = {}
        _flatten(tree, "", flat, leaf=lambda x: x.full_tensor().numpy())
        out["decode", arch, "serve"] = {"logits": logits, "cache": flat}
    return out


def as_numpy_state(module) -> dict:
    return {k: np.ascontiguousarray(v.detach().numpy())
            for k, v in module.state_dict().items()}
