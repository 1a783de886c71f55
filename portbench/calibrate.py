"""Readings that set the check's limits (not run by the benchmark's runs).

    python3 portbench/calibrate.py --workload <name> --seeds 1-3,7

For each seed, at the cell's own size on the card: the cell's traces and
weights, one greedy rollout of the program's device engine (the window's
own call), the cell's sample replayed once by the plain scheduler, and
two readings of ``score_err`` on those rows: the program's, and the
control's, the plain network in TF32 (operands rounded to 10 mantissa
bits, one step below the configuration's float32) in the program's
place.  One JSON line per seed on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "src"))


def seeds(spec: str) -> list:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def readings(cell, seed: int, device) -> dict:
    import numpy as np
    import torch

    from portbench import harness, traffic_gen
    from portbench.reference import dfp as ref_dfp
    t0 = time.perf_counter()
    traces = traffic_gen.make_traces(cell.mix, seed)
    weights = ref_dfp.make_weights(cell.config, seed, device)
    agent, res = harness.build_agent(cell.config, weights, device)
    sim = harness.build_sim(cell.config, traces, agent, res, device)
    t1 = time.perf_counter()
    envs = harness.sample_envs(seed, sim.rollout().decided.sum(axis=0),
                               cell.config["check"]["sample_envs"])
    recorder = harness.ScoreRecorder(agent, envs, device)
    t2 = time.perf_counter()
    with recorder:
        recorder.next_rollout()
        ro = sim.rollout()
    t3 = time.perf_counter()
    scores = harness.program_scores(ro, recorder.rollouts[0], envs)
    del sim, agent, recorder
    torch.cuda.empty_cache()
    sample = harness.replay_sample(cell.config, traces, ro, envs)
    err, dev, gap = harness.judge(cell.config, sample, scores, weights,
                                  device)
    c_err, c_dev, c_gap = harness.judge(cell.config, sample, None, weights,
                                        device, precision="tf32")
    return {"seed": seed, "schedule_mismatches": sample.mismatches,
            "score_err": err, "score_dev": dev, "action_gap": gap,
            "control_score_err": c_err, "control_score_dev": c_dev,
            "control_action_gap": c_gap,
            "decisions_checked": int(len(sample.rows)),
            "queue_len_mean": float(sample.queue_len.mean()),
            "queue_len_max": int(sample.queue_len.max()),
            "rollout_decisions": int(ro.stats.decisions),
            "rounds_run": int(ro.stats.rounds_run),
            "jobs_max": int(max(len(t.submit) for t in traces)),
            "jobs_mean": float(np.mean([len(t.submit) for t in traces])),
            "setup_s": t1 - t0, "warm_rollout_s": t2 - t1,
            "rollout_s": t3 - t2, "check_s": time.perf_counter() - t3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    for s in seeds(args.seeds):
        print(json.dumps({"workload": args.workload,
                          **readings(cell, s, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
