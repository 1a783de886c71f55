"""Run one cell of the port's benchmark on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds (or loads) the kernels into ``build/repro_torch_kernels/``,
makes the traces and the weights from ``--seed``, and warms the cell's
shapes up with one rollout.  With ``--trace 0`` the window then runs
whole greedy rollouts of the device engine back to back, as many as end
within ``--seconds``, and the result line carries the cell's end-to-end
metrics.  With ``--trace 1`` the warm-up also records what the kernels'
costs need (``harness.Probe``), the window is ``TRACED_ROLLOUTS`` whole
rollouts under the profiler, and the line carries the per-layer metrics,
read by ``portbench/layer_metrics/<name>.py``.  Every run then checks a
sample of the window's answers against the plain reference
(``portbench/reference/``) and prints each number compared beside its
limit, last on standard error and last in the result line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                              # noqa: E402
import contextlib                                            # noqa: E402
import json                                                  # noqa: E402
import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402
from pathlib import Path                                     # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "src"))

# Whole rollouts in the traced window: the trace's post-processing grows
# with its ~300,000 device operations a rollout, and the traced run has
# to end as soon as the untraced one.
TRACED_ROLLOUTS = 1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card and does not "
            "fall back to the CPU")
        return 2
    from portbench import harness
    cell = harness.load_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, this machine has "
            f"{torch.cuda.device_count()}")
        return 2
    harness.check_cell(cell.config, cell.mix)
    # The plain reference multiplies in float32: TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run(cell, args.seed, args.seconds, args.trace, device)
    if out is None:
        return 3
    line, checks = out
    for name, (value, limit) in checks.items():
        log(f"check {name}: {value!r} (limit {limit!r})")
    print(json.dumps(line), flush=True)
    return 0


def run(cell, seed: int, seconds: float, traced: int, device):
    """Set-up, window and check of one run on ``device``; returns (result
    line, {number: (value, limit)}), or None when a module of a JAX
    package was loaded."""
    import torch

    from portbench import harness, traffic_gen, yardstick
    from portbench.reference import dfp as ref_dfp
    from repro_torch.kernels.fused_mlp import kernel as fm
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.window_pack import kernel as wp

    config, mix = cell.config, cell.mix
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # --- set-up: kernels, traces, weights, warm-up
    if cuda:
        builds = [fm.build, wp.build]
        if config["agent"]["state_module"] == "attention":
            builds.append(fa.build)
        for b in builds:
            info = b()
            log(f"[setup] {info.library.name}: {info.seconds:.3f} s of nvcc")
    t0 = time.perf_counter()
    traces = traffic_gen.make_traces(mix, seed)
    t_traces = time.perf_counter() - t0
    weights = ref_dfp.make_weights(config, seed, device)
    agent, res = harness.build_agent(config, weights, device)
    del weights
    t0 = time.perf_counter()
    sim = harness.build_sim(config, traces, agent, res, device)
    t_pack = time.perf_counter() - t0
    lay = sim.layout
    probe = harness.Probe(agent, config) if traced else None
    t0 = time.perf_counter()
    with probe or contextlib.nullcontext():
        warm = sim.rollout()
    sync()
    t_warm = time.perf_counter() - t0
    setup_s = time.perf_counter() - T_START
    log(f"[setup] {cell.name}: N={lay.n_envs} J={lay.n_jobs} "
        f"U={lay.n_units} state_dim {lay.state_dim}; traces {t_traces:.2f} "
        f"s, pack {t_pack:.2f} s, warm-up rollout {t_warm:.2f} s; set-up "
        f"{setup_s:.2f} s")

    # --- the window; the checked environments are drawn from the seed
    # out of the warm-up's decisions (every rollout does the same work)
    envs = harness.sample_envs(seed, warm.decided.sum(axis=0),
                               config["check"]["sample_envs"])
    recorder = harness.ScoreRecorder(agent, envs, device)
    trace = ctx = None
    prof = contextlib.nullcontext()
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
    t_prof = time.perf_counter()
    with prof, recorder:
        t0 = time.perf_counter()
        win = harness.timed_rollouts(
            sim, seconds, sync, recorder,
            count=TRACED_ROLLOUTS if traced else None)
        sync()
        window_s = time.perf_counter() - t0
    if traced:
        t1 = time.perf_counter()
        trace = yardstick.device_events(prof)
        log(f"[trace] profiler start {t0 - t_prof:.2f} s, stop "
            f"{t1 - t0 - window_s:.2f} s, read "
            f"{time.perf_counter() - t1:.2f} s")
    del prof
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = harness.forbidden_modules()
    if found:
        log(f"modules of a JAX package are loaded: {found}")
        return None
    log(f"[window] {len(win.walls)} rollouts in {win.seconds:.3f} s: "
        f"{win.decisions} decisions, {win.rounds_run} rounds "
        f"({win.deciding_rounds} deciding), {win.host_syncs} host syncs; "
        f"walls {', '.join(f'{w:.3f}' for w in win.walls)} s")

    if traced:
        ctx = MetricContext(config, lay, win, trace, window_s, probe, warm)
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(ROOT, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = yardstick.busy_seconds(trace.intervals)
        log(f"[trace] {yardstick.PEAKS}; card: {card_power()}; busy "
            f"{busy:.4f} s of a {window_s:.4f} s window, "
            f"{trace.n_ops} device operations")
    else:
        metrics = {
            "decisions_per_s": {"value": win.decisions / win.seconds,
                                "unit": "decisions/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        wanted = {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in metrics.items() if k in wanted}

    # --- the check, once the program's state is freed
    k = harness.pick_rollout(seed, len(win.rollouts))
    ro = win.rollouts[k]
    scores = harness.program_scores(ro, recorder.rollouts[k], envs)
    n_attempted = win.decisions
    del sim, agent, win, ctx, recorder, warm, probe
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    weights = ref_dfp.make_weights(config, seed, device)
    chk = harness.reference_check(config, traces, ro, envs, scores, weights,
                                  device)
    log(f"[check] rollout {k}, {len(envs)} environments, "
        f"{chk.decisions} decisions (queue length mean "
        f"{chk.queue_len_mean:.2f}, max {chk.queue_len_max}) in "
        f"{time.perf_counter() - t0:.2f} s; scores {chk.score_dev!r}, "
        f"actions {chk.action_gap!r} of the scale")
    limit = config["check"]["score_err_limit"]
    checks = {"schedule_mismatches": (chk.schedule_mismatches, 0),
              "score_err": (chk.score_err, limit)}
    correct = (chk.schedule_mismatches == 0 and limit is not None
               and chk.score_err <= limit)
    line = {"correct": bool(correct), "attempted": int(n_attempted),
            "failed": 0, "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(device) if cuda
                                else "cpu"),
                       "count": cell.chips,
                       "memory_peak_bytes": int(mem_peak)}}
    if traced:
        line["device"]["busy_s"] = yardstick.busy_seconds(trace.intervals)
        line["device"]["window_s"] = window_s
        line["breakdown"] = yardstick.breakdown(trace)
    line["check"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return line, checks


class MetricContext:
    """What a per-layer metric's reader reads: the configuration, the
    rollout layout, the traced window's counters and device trace, and
    the probe of the warm-up rollout over the same traces (every rollout
    of a run does the same work, so a reader costs a kernel's launch by
    the probe's mean and counts the launches in the trace)."""

    def __init__(self, config, layout, window, trace, window_s, probe,
                 probe_rollout):
        import numpy as np
        self.config, self.layout = config, layout
        self.window, self.trace, self.window_s = window, trace, window_s
        self.front = (np.stack([t.cpu().numpy() for t in probe.front])
                      if probe.front else np.zeros((0, 4), np.int64))
        decided = probe_rollout.decided
        self.deciding = decided[decided.any(axis=1)]          # (calls, N)
        self.qlens = ([q.cpu().numpy() for q in probe.qlens]
                      if probe.qlens else None)


if __name__ == "__main__":
    sys.exit(main())
