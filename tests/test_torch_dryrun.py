"""The port's dry run (``repro_torch.launch.dryrun``): one cell at full
width and depth on a fake world of 256 ranks, in a process of its own,
and the counter under it on a product whose counts are known."""
import json
import os
import subprocess
import sys
import textwrap

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.distributed.costs import cell_costs as jcell_costs


def _run(code: str, timeout: int = 600) -> str:
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=dict(os.environ, PYTHONPATH="src"))
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_dryrun_single_cell_runs():
    """gemma-2b x prefill_32k on the 16 x 16 mesh: an ``ok`` record with
    a compute term, collectives, memory, and the reference's model flops."""
    out = _run("""
        import json
        from repro_torch.launch.dryrun import run_cell
        rec = run_cell("gemma-2b", "prefill_32k", multi_pod=False)
        print("REC" + json.dumps(rec))
    """)
    rec = json.loads(out.split("REC", 1)[1])
    assert rec["status"] == "ok", rec
    assert rec["roofline"]["compute_s"] > 0
    assert rec["model_flops_global"] == jcell_costs(
        jget_config("gemma-2b"), JSHAPES["prefill_32k"]).model_flops_global
    assert rec["collective_ops"] > 0 and rec["wire_bytes_per_device"] > 0
    assert rec["mem"]["argument_bytes"] > 0 and rec["mem"]["temp_bytes"] > 0
    assert 0 < rec["useful_ratio"] <= 1
    assert rec["flops_per_device"] >= rec["model_flops_per_device"]
    assert rec["counter"]


def test_step_counter_on_a_sharded_product():
    """x (Shard(0) over "data") @ w (rows over "data", fsdp), gathered on
    use: one all-gather of w's rows over 16 ranks, w's bytes * 15/16 on
    the wire; the product's flops split 16 ways (the "data" dim), the
    "model" dim repeating it."""
    out = _run("""
        import torch
        from torch.distributed.tensor import distribute_tensor
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.distributed import sharding as sh
        from repro_torch.distributed.comm_analysis import StepCounter
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import make_production_mesh
        fake_world(256)
        mesh = make_production_mesh()
        rules = sh.default_rules(mesh)
        with FakeTensorMode():
            x = distribute_tensor(torch.zeros(64, 2048), mesh,
                                  sh.placements(sh.P("data", None), mesh))
            w = distribute_tensor(torch.zeros(2048, 4096), mesh,
                                  sh.placements(sh.P("data", None), mesh))
            c = StepCounter()
            with c, sh.use_rules(rules):
                y = x @ sh.shard(w, None, None)
        print("RES", c.flops, c.wire_bytes, c.count(), c.by_kind())
    """)
    flops, wire, n, kinds = out.split("RES", 1)[1].split(maxsplit=3)
    assert float(flops) == 2 * 64 * 2048 * 4096 / 16
    assert float(wire) == 2048 * 4096 * 4 * 15 / 16
    assert int(n) == 1 and "all-gather" in kinds


def test_b7_and_b8_refuse_dtensors():
    """A sharded model runs the "torch" backend: the kernels' wrappers
    raise on a DTensor (here on the CPU, before their plain path)."""
    out = _run("""
        import torch
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.distributed import sharding as sh
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.ssd import ssd
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import make_production_mesh
        fake_world(256)
        mesh = make_production_mesh()
        rep = sh.placements(sh.P(None, None, None, None), mesh)
        q = distribute_tensor(torch.zeros(2, 8, 4, 16), mesh, rep)
        x = distribute_tensor(torch.zeros(2, 8, 4, 16), mesh, rep)
        dt = torch.zeros(2, 8, 4)
        bc = torch.zeros(2, 8, 1, 16)
        for name, call in (("flash", lambda: flash_attention(q, q, q)),
                           ("ssd", lambda: ssd(x, dt, dt, bc, bc, chunk=4))):
            try:
                call()
            except RuntimeError as e:
                assert "DTensor" in str(e), e
                print("REFUSED", name)
    """)
    assert out.count("REFUSED") == 2
