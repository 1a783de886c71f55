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


def run_ranks(fn, tmp_path, *args, world: int = 8):
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks -> rank 0's
    result."""
    store = os.path.join(str(tmp_path), "store")
    out = os.path.join(str(tmp_path), "rank0.pt")
    mp.start_processes(_entry, args=(world, store, fn, args, out),
                       nprocs=world, start_method="spawn")
    return torch.load(out, weights_only=False)


def _mesh():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))


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
    from repro_torch.configs import smoke_config
    from repro_torch.convert import _flatten
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import OptConfig, opt_init
    cfg = smoke_config(arch)
    opt = OptConfig(lr=1e-3, weight_decay=0.0)
    params = transformer.LM(cfg, torch.float32, "cpu")
    params.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    st = opt_init(params, opt)
    mesh = _mesh()
    rules = sh.default_rules(mesh)
    pspecs = sh.param_pspecs(params, rules)
    st = sh.distribute_tree(st, steps.param_pspecs_for_opt(st, pspecs), mesh)
    sh.distribute_params(params, rules, pspecs)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    b = sh.distribute_tree(b, steps.batch_pspec(rules, b), mesh)
    step = steps._bind_rules(steps.make_train_step(cfg, opt), rules)
    params, st, m = step(params, st, b)
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


def as_numpy_state(module) -> dict:
    return {k: np.ascontiguousarray(v.detach().numpy())
            for k, v in module.state_dict().items()}
