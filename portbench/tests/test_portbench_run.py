"""``run.py`` from the command line: without a card it exits non-zero and
prints no result; on a card (marked ``cuda``) one short run prints the
JSON result line."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CMD = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
       "mlp-sweep-s1", "--seed", "2147483659", "--seconds", "1", "--trace"]


def test_exits_nonzero_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(CMD + ["0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(CMD + ["0"], capture_output=True, text=True,
                         timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"decisions_per_s", "setup_s"}


def test_window_runs_whole_rollouts_that_end_in_time(monkeypatch):
    """Untraced, a rollout starts only where it ends within the seconds;
    traced, the window is the given count of rollouts."""
    from types import SimpleNamespace

    from portbench import harness
    clock = [0.0]
    monkeypatch.setattr(harness.time, "perf_counter", lambda: clock[0])

    class Sim:
        def rollout(self):
            clock[0] += 3.0
            return SimpleNamespace(stats=SimpleNamespace(
                decisions=10, rounds_run=5, rounds=4, host_syncs=2))

    rec = SimpleNamespace(next_rollout=lambda: None)
    win = harness.timed_rollouts(Sim(), 10.0, lambda: None, rec)
    assert win.walls == [3.0, 3.0, 3.0] and win.decisions == 30
    assert win.seconds <= 10.0
    win = harness.timed_rollouts(Sim(), 10.0, lambda: None, rec, count=1)
    assert len(win.walls) == 1
