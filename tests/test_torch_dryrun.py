"""The port's dry run (``repro_torch.launch.dryrun``): a cell at full
width and depth on a fake world of 256 ranks in a process of its own; a
run of cells in one process, the first of which fails; and the counter
under it on a product whose counts are known.  ``rule_set_cell`` runs a
cell under one of the three rule sets, for ``test_torch_dryrun_seq`` and
``test_torch_dryrun_ssm``."""
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


def rule_set_cell(arch: str, shape: str, multi_pod: bool,
                  rules: str) -> None:
    """``run_cell`` of one cell under the rule set ``rules`` in a process
    of its own: it records ``ok``, and under sequence parallelism ("opt",
    "serve") its collectives include the all-gather before the
    column-parallel products and the reduce-scatter after the row-parallel
    ones.  (The tests that call it sit in files of their own, which the
    test runner's workers take up side by side.)"""
    out = _run(f"""
        import json
        from repro_torch.distributed.sharding import RULE_SETS
        from repro_torch.launch.dryrun import run_cell
        rec = run_cell({arch!r}, {shape!r}, {multi_pod!r},
                       RULE_SETS[{rules!r}], tag={rules!r})
        print("REC" + json.dumps({{k: rec.get(k) for k in (
            "status", "error", "collective_bytes_by_kind")}}))
    """, timeout=900)
    rec = json.loads(out.split("REC", 1)[1])
    assert rec["status"] == "ok", rec["error"]
    if rules != "baseline":       # sequence parallelism's collectives
        assert {"all-gather", "reduce-scatter"} <= set(
            rec["collective_bytes_by_kind"]), rec


def test_a_failed_cell_leaves_the_next_cells_sound():
    """One process runs a 2 x 16 x 16 cell made to raise inside its step
    after its first collectives (the vocab-parallel embedding), a 16 x 16
    cell, then gemma-2b x decode_32k x 2 x 16 x 16 under the serve rules,
    which records ``ok`` as it does alone: no mesh or process group of an
    earlier world reaches a later cell.  The middle cell's world of
    another size is what a stale mesh needs to go wrong: a cached
    sharding spec still named the first world's groups, and the third
    cell failed without it having to follow a failed one."""
    out = _run("""
        import json
        from repro_torch.distributed.sharding import serve_rules
        from repro_torch.launch.dryrun import run_cell
        from repro_torch.models import layers
        lookup = layers._embed_rows

        def raising(*a, **k):
            lookup(*a, **k)
            raise RuntimeError("raised after the embedding's collectives")

        layers._embed_rows = raising
        recs = [run_cell("gemma-2b", "prefill_32k", True, serve_rules)]
        layers._embed_rows = lookup
        recs += [run_cell("gemma-2b", "decode_32k", multi, serve_rules)
                 for multi in (False, True)]
        print("REC" + json.dumps([[r["status"], r.get("error")]
                                  for r in recs]))
    """, timeout=900)
    recs = json.loads(out.split("REC", 1)[1])
    assert recs[0] == ["failed", "RuntimeError: raised after the "
                       "embedding's collectives"], recs[0]
    assert recs[1][0] == "ok" and recs[2][0] == "ok", recs


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
