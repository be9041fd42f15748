"""Run a cell as the check does, one process a run, and read the spread.

    python3 bench/tools/sets.py --workload <cell> --seconds 30 \\
        --seeds 1,2,3,4,5,6 [--sets 2] [--trace 0] [--out sets.jsonl]

For each set, runs ``bench/run.py`` once per seed (the same seeds in
every set), appends every result line with its seed, set, exit code and
wall time to ``--out``, and then prints per metric each set's median and
spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median, and
the bound it suggests (five times the wider spread, at least 1 %).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    """(median, (q3 - q1) / median) of ``values``."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out) if args.out else None
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for k in range(args.sets):
        for seed in seeds:
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "bench/run.py", "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(args.seconds),
                 "--trace", str(args.trace)], cwd=ROOT, capture_output=True,
                text=True)
            wall = time.perf_counter() - t0
            line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() \
                else "{}"
            try:
                res = json.loads(line)
            except json.JSONDecodeError:
                res = {}
            row = {"set": k, "seed": seed, "rc": p.returncode,
                   "wall_s": wall, "result": res,
                   "stderr_tail": p.stderr[-600:]}
            rows.append(row)
            if out:
                with out.open("a") as f:
                    f.write(json.dumps(row) + "\n")
            m = {n: round(v["value"], 4)
                 for n, v in res.get("metrics", {}).items()}
            print(json.dumps({"set": k, "seed": seed, "rc": p.returncode,
                              "correct": res.get("correct"),
                              "wall_s": round(wall, 1), "metrics": m,
                              "check": {n: v["value"] for n, v in
                                        res.get("check", {}).items()}}),
                  flush=True)
            if p.returncode:
                print(p.stderr[-2000:], flush=True)
    names = sorted({n for r in rows for n in r["result"].get("metrics", {})})
    for n in names:
        per = []
        for k in range(args.sets):
            v = [r["result"]["metrics"][n]["value"] for r in rows
                 if r["set"] == k and n in r["result"].get("metrics", {})]
            if len(v) >= 2:
                per.append(spread(v))
        if per:
            widest = max(s for _, s in per)
            print(json.dumps({"metric": n,
                              "medians": [m for m, _ in per],
                              "spreads": [s for _, s in per],
                              "bound_5x": max(0.01, 5 * widest)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
