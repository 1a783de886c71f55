"""The PyTorch port stands alone: it imports without jax and ml_dtypes,
and no file of it (nor chip_smoke.py) imports jax, ml_dtypes or the JAX
package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            f"for name in {MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) > 20


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_scan_covers_every_slice():
    """Both scans above walk the whole package; the modules of each
    ported slice are among them."""
    for name in ("repro_torch.serve.service",
                 "repro_torch.serve.reload",
                 "repro_torch.checkpoint.store",
                 "repro_torch.obs.metrics",
                 "repro_torch.obs.profiling",
                 "repro_torch.kernels.fused_mlp.ops",
                 "repro_torch.kernels.window_pack.ops",
                 "repro_torch.kernels.window_pack.kernel",
                 "repro_torch.kernels._build",
                 "repro_torch.sim.device",
                 "repro_torch.core.policy_api",
                 "repro_torch.core.policies",
                 "repro_torch.baselines",
                 "repro_torch.baselines.prb",
                 "repro_torch.baselines.cp",
                 "repro_torch.baselines.dras",
                 "repro_torch.baselines.cosched",
                 "repro_torch.eval",
                 "repro_torch.eval.matrix",
                 "repro_torch.eval.tournament",
                 "repro_torch.core.replay",
                 "repro_torch.core.train",
                 "repro_torch.sim.vector",
                 "repro_torch.workloads.registry",
                 "repro_torch.workloads.drift",
                 "repro_torch.workloads.jobsets",
                 "repro_torch.workloads.sweep",
                 "repro_torch.nn.optim",
                 "repro_torch.nn.queue_encoder",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.configs",
                 "repro_torch.configs.base",
                 "repro_torch.configs.zamba2_7b",
                 "repro_torch.distributed.sharding",
                 "repro_torch.data.pipeline",
                 "repro_torch.models.layers",
                 "repro_torch.models.attention",
                 "repro_torch.models.mamba2",
                 "repro_torch.models.transformer",
                 "repro_torch.models.mla",
                 "repro_torch.models.moe",
                 "repro_torch.launch.steps",
                 "repro_torch.launch.serve",
                 "repro_torch.kernels.ssd.ops",
                 "repro_torch.kernels.ssd.kernel",
                 "repro_torch.kernels.ssd.ref"):
        assert name in MODULES, name
