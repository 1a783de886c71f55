"""The traced run of ``run.py`` with the program's span recorder wired in
(not run by the benchmark's runs).

    python3 portbench/phase_run.py --workload <name> --seed <n> \
        --seconds <s>

Runs ``run.py``'s ``--trace 1`` path unchanged but for four things: the
device engine is built with a ``repro_torch.obs.SpanRecorder``
(``setup.pack``), the traced rollout records into it, the profiler's
records are read once by ``phases.read_profile`` (the same device trace,
plus the launch records), and the metric context carries the spans and
each device operation's phase.  The cell's per-layer metrics are then
read with the six span metrics of ``PHASE_METRICS`` added, and the phase
table, the attribution's coverage and the read's time go to standard
error as ``[trace]`` lines.  If ``run.py`` or ``harness.py`` stops going
through a name that ``wire`` replaces, the run does not pass for a good
one: the metric context raises when it finds no spans or no launch
records, and the run exits 3 when no metric context was made.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "src"))

from portbench import run as bench  # noqa: E402  (starts run.py's clock)

PHASE_METRICS = {"pack_s": "s", "host_issue_ms_per_round": "ms/round",
                 "sync_wait_ms_per_round": "ms/round",
                 "sim_device_ms_per_round": "ms/round",
                 "forward_device_ms_per_call": "ms/call",
                 "idle_share.round_loop": "%"}


def wire(rec) -> set:
    """Patch ``run.py``'s collaborators so the traced run records spans.
    Returns the set into which the metric context adds ``"context"`` once
    it has read the spans and the launch records."""
    import repro_torch.sim as rsim

    from portbench import harness, phases, yardstick
    load_cell, build_sim = harness.load_cell, harness.build_sim
    timed_rollouts = harness.timed_rollouts
    read, used = {}, set()

    def load_cell_(root, workload):
        cell = load_cell(root, workload)
        have = {m["name"] for m in cell.per_layer}
        cell.per_layer += [{"name": n, "unit": u}
                           for n, u in PHASE_METRICS.items() if n not in have]
        return cell

    def build_sim_(*args, **kw):
        cls = rsim.DeviceSimulator
        rsim.DeviceSimulator = functools.partial(cls, spans=rec)
        try:
            return build_sim(*args, **kw)
        finally:
            rsim.DeviceSimulator = cls

    def timed_rollouts_(sim, seconds, sync, recorder, count=None):
        sim.rollout = functools.partial(type(sim).rollout, sim, spans=rec)
        try:
            return timed_rollouts(sim, seconds, sync, recorder, count)
        finally:
            del sim.rollout

    def device_events_(prof):
        read["profile"] = phases.read_profile(prof)
        return read["profile"].trace

    class MetricContext(bench.MetricContext):
        def __init__(self, *args):
            super().__init__(*args)
            t0 = time.perf_counter()
            missing = sorted({"setup.pack", "round"} - rec.counts.keys())
            if missing or "profile" not in read:
                raise RuntimeError(
                    f"phase_run's patches did not take: spans {missing} "
                    f"missing, launch records "
                    f"{'read' if 'profile' in read else 'not read'}; "
                    f"run.py or harness.py no longer calls the names that "
                    f"wire() replaces")
            self.spans = rec.spans()
            prof = read.pop("profile")
            at = phases.op_spans(self.spans, prof)
            self.op_phase = [self.spans[i].name if i >= 0 else None
                             for i in at]
            rows = phases.phase_table(self.spans, self.trace.intervals,
                                      self.op_phase)
            t_read = time.perf_counter() - t0
            for line in phases.table_lines(rows):
                bench.log(f"[trace] {line}")
            n_ops = len(at)
            put = n_ops - (rows[None].ops if None in rows else 0)
            idle = self.window_s - yardstick.busy_seconds(self.trace.intervals)
            below = sum(r.idle_ns for n, r in rows.items()
                        if n not in (None, "rollout", "setup.pack")) / 1e9
            bench.log(f"[trace] coverage: {put} of {n_ops} device operations "
                      f"put down to a span ({100.0 * put / max(n_ops, 1):.3f} "
                      f"%), {len(prof.launches)} launch records; idle "
                      f"{below:.4f} s of the window's {idle:.4f} s inside "
                      f"spans below rollout ({100.0 * below / idle:.2f} %); "
                      f"rounds {phases.rounds(self.spans)}, worst round "
                      f"uncovered by its phases "
                      f"{100.0 * phases.round_cover(self.spans):.4f} %; "
                      f"attribution read in {t_read:.2f} s")
            gaps = phases.clock_gaps(self.spans, prof, at, "sync.gate")
            if gaps:
                held = sum(a >= 0 and b >= 0 for a, b in gaps)
                lead, tail = (sorted(g[k] for g in gaps) for k in (0, 1))
                bench.log(f"[trace] clock check "
                          f"{'passed' if held == len(gaps) else 'FAILED'}: "
                          f"{held} of {len(gaps)} sync.gate spans hold "
                          f"their launch records and their operations' "
                          f"device intervals; the first launch starts "
                          f"{lead[0] / 1e3:.1f} us (min) / "
                          f"{lead[len(lead) // 2] / 1e3:.1f} us (median) "
                          f"after the span opens, and the span closes "
                          f"{tail[0] / 1e3:.1f} / "
                          f"{tail[len(tail) // 2] / 1e3:.1f} us after its "
                          f"last operation ends on the card")
            used.add("context")

    harness.load_cell, harness.build_sim = load_cell_, build_sim_
    harness.timed_rollouts, yardstick.device_events = (timed_rollouts_,
                                                       device_events_)
    bench.MetricContext = MetricContext
    return used


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from repro_torch.obs import SpanRecorder
    used = wire(SpanRecorder())
    rc = bench.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])
    if rc == 0 and not used:
        bench.log("[trace] phase_run: run.py read no metric context, so "
                  "no span was read")
        return 3
    return rc


if __name__ == "__main__":
    sys.exit(main())
