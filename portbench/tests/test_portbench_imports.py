"""Nothing the harness or the reference loads is a JAX package: the top
level of every loaded module's name, compared whole (``repro_torch``
begins with ``repro`` and is the program, so it is allowed)."""
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib.util
spec = importlib.util.spec_from_file_location("pbrun", {run!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
{body}
print(json.dumps(sorted(sys.modules)))
"""


def loaded(body: str) -> set:
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                        run=str(ROOT / "portbench" / "run.py"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def tops(modules) -> set:
    return {m.split(".")[0] for m in modules}


def test_harness_loads_no_jax_package():
    readers = "; ".join(
        f"harness.metric_reader(ROOT, {m['name']!r})"
        for m in BENCH["per_layer"])
    mods = loaded(
        "from pathlib import Path\n"
        "from portbench import harness, calibrate\n"
        "from repro_torch.sim import DeviceSimulator\n"
        "from repro_torch.core.agent import MRSchAgent\n"
        f"ROOT = Path({str(ROOT)!r})\n{readers}")
    assert "repro_torch" in tops(mods)
    assert not tops(mods) & set(harness.FORBIDDEN)


def test_reference_loads_neither_program_nor_jax():
    mods = loaded("from portbench.reference import dfp, sched\n"
                  "from portbench import traffic_gen, yardstick")
    assert not tops(mods) & {*harness.FORBIDDEN, "repro_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("repro", "repro.sim", "jax", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    found = harness.forbidden_modules()
    assert {"repro", "repro.sim", "jax", "jaxlib.xla", "flax"} <= set(found)
    assert not [m for m in found if m.split(".")[0] in
                ("repro_torch", "jaxtyping_like")]
