#!/usr/bin/env python3
"""Time the device engine's rollouts of several trees of this repo on one
card, in turns.

    python tools/device_round_ab.py TREE [TREE ...] [--turns 2] [--reps 3]

Each turn runs every tree once, in the order A B, then B A, and so on.
Each run is a fresh process that imports that tree's ``chip_smoke.py``
(so each tree is measured with its own code and its own kernels) and
runs its device-engine phase on cell (c), the paper-width MLP agent over
64 full-scale S1 traces, and on cell (f), the attention agent (Q = 128)
on its traces: one warm-up rollout, ``--reps`` timed greedy rollouts
(the median is kept), then one rollout under the profiler.  It prints
each run's log, one JSON line per run, and then each tree's medians over
its runs: rollout wall seconds, decisions/s, device ms per rollout and
device operations per round.  Compare trees only within one invocation:
host speed differs between machines and calls.  To compare a commit
with its parent, unpack the parent into a git-ignored directory
(``git archive PARENT | tar -x -C results/parent``) and pass both.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

KEYS = ("wall_s", "dps", "device_busy_ms", "device_ops_per_round")


def child(tree: str, reps: int) -> None:
    """One run: this tree's chip_smoke phases on cells (c) and (f)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import chip_smoke as cs
    from repro_torch.core import AgentConfig, MRSchAgent
    from repro_torch.workloads import ThetaConfig
    if not cs.torch.cuda.is_available():
        sys.exit("device_round_ab: no CUDA device")
    cs.phase_env()
    res = ThetaConfig().resources()
    mlp, _ = cs.phase_device_main(MRSchAgent(res, AgentConfig(seed=0)), None,
                                  cs.MLP_FORWARD, "device", reps, False)
    attn = MRSchAgent(res, AgentConfig(state_module="attention", seed=0))
    att, _ = cs.phase_device_main(attn, cs.attn_trace, cs.ATTN_FORWARD,
                                  "attn device", reps, False)
    print(json.dumps({"tree": tree, "c": {k: mlp[k] for k in KEYS},
                      "f": {k: att[k] for k in KEYS}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0], args.reps)
        return 0
    runs = {tree: [] for tree in args.trees}
    for turn in range(args.turns):
        order = args.trees if turn % 2 == 0 else args.trees[::-1]
        for tree in order:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", "--reps",
                 str(args.reps), tree], capture_output=True, text=True)
            print(proc.stdout + proc.stderr, flush=True)
            if proc.returncode != 0:
                print(f"device_round_ab: the run of {tree} failed "
                      f"({proc.returncode})", file=sys.stderr)
                return 1
            runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for tree, rs in runs.items():
        med = {cell: {k: statistics.median(r[cell][k] for r in rs)
                      for k in KEYS} for cell in ("c", "f")}
        print(f"[ab] {tree}: medians of {len(rs)} runs {json.dumps(med)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
