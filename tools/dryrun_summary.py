#!/usr/bin/env python3
"""Summarise dry-run records (``repro_torch.launch.dryrun`` or the JAX
package's ``repro.launch.dryrun``), one JSON file a cell.

    python tools/dryrun_summary.py DIR [DIR ...]
        status counts and summed cell walls per rule set of each DIR
    python tools/dryrun_summary.py DIR --compare baseline opt [--shape train_4k]
        per cell of the shape: temporaries, wire bytes and collective
        bytes by kind under the two rule sets (the port's records)
    python tools/dryrun_summary.py DIR --cell ARCH SHAPE MESH RULES
        one record's counts (MESH single or multi)

A file's rule set is the suffix of its name (``__opt``, ``__serve``;
none for baseline).
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os

RULES = ("baseline", "opt", "serve")


def load(directory: str) -> dict:
    """{(arch, shape, mesh, rules): record} of the records in
    ``directory``."""
    out = {}
    for path in glob.glob(os.path.join(directory, "*.json")):
        parts = os.path.basename(path)[:-len(".json")].split("__")
        rules = parts[3] if len(parts) > 3 else "baseline"
        with open(path) as fh:
            out[tuple(parts[:3]) + (rules,)] = json.load(fh)
    return out


def statuses(recs: dict) -> None:
    for rules in RULES:
        got = [r for k, r in recs.items() if k[3] == rules]
        if not got:
            continue
        n = collections.Counter(r["status"] for r in got)
        wall = sum(r.get("wall_s", 0.0) for r in got)
        failed = sorted(f"{k[0]} x {k[1]} x {k[2]}" for k, r in recs.items()
                        if k[3] == rules and r["status"] == "failed")
        print(f"{rules}: ok {n['ok']}, failed {n['failed']}, skipped "
              f"{n['skipped']}; cells' wall {wall:.1f} s")
        for cell in failed:
            print(f"  failed: {cell}")


def compare(recs: dict, a: str, b: str, shape: str) -> None:
    print(f"arch mesh | temp GB {a} / {b} | wire GB {a} / {b} | "
          f"bytes by kind (GB) {a} ; {b}")
    for (arch, sname, mesh, rules), ra in sorted(recs.items()):
        if sname != shape or rules != a:
            continue
        rb = recs.get((arch, sname, mesh, b))
        if rb is None or "ok" not in (ra["status"], rb["status"]) or \
                ra["status"] != rb["status"]:
            continue

        def kinds(r):
            return ", ".join(f"{k} {v / 1e9:.2f}" for k, v in
                             sorted(r["collective_bytes_by_kind"].items()))

        print(f"{arch} {mesh} | {ra['mem']['temp_bytes'] / 1e9:.2f} / "
              f"{rb['mem']['temp_bytes'] / 1e9:.2f} | "
              f"{ra['wire_bytes_per_device'] / 1e9:.2f} / "
              f"{rb['wire_bytes_per_device'] / 1e9:.2f} | {kinds(ra)} ; "
              f"{kinds(rb)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--cell", nargs=4, metavar=("ARCH", "SHAPE", "MESH",
                                                "RULES"))
    args = ap.parse_args(argv)
    for d in args.dirs:
        recs = load(d)
        print(f"== {d} ({len(recs)} records)")
        if args.cell:
            r = recs[tuple(args.cell)]
            print(json.dumps({k: r.get(k) for k in (
                "status", "flops_per_device", "wire_bytes_per_device",
                "collective_ops", "collective_bytes_by_kind", "mem",
                "wall_s")}))
        elif args.compare:
            compare(recs, *args.compare, args.shape)
        else:
            statuses(recs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
