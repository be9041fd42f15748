"""Find an open-loop cell's knee: the highest arrival rate it sustains.

    python3 bench/tools/sweep.py --workload <cell> --rates 6,8,10 \\
        [--seconds 20] [--warm 6] [--seed n]

One process builds the cell once (weights, engine, buckets, contexts),
then for each rate runs the mix's traffic at that rate for ``--warm``
seconds and a window of ``--seconds``, prints a JSON line with the
queue at the window's ends, the requests due and finished, the TTFT and
TPOT tails and the mean step, and lets the engine drain before the next
rate.  A rate is sustained when the waiting queue does not grow across
the window.  The knee goes into the mix file by hand (``knee_rps``,
with ``rate_rps`` at 0.8 of it): the benchmark's runs never search.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench.harness import cell, model_config as mc, stats  # noqa: E402
from bench.harness import traffic as traffic_lib  # noqa: E402
from bench.harness import weights as weights_lib  # noqa: E402
from bench.harness.drive import Driver  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--warm", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--fill", type=float, default=0.0,
                    help="seconds of traffic at the first rate before "
                    "the sweep, so that every rate runs on a pool that "
                    "is already full of cached blocks (evicting)")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = cell.cell_entry(bench, args.workload)
    cfg = mc.load(entry["config"])
    mix = cell.load_json(cell.BENCH / "mixes" / f"{entry['traffic']}.json")
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import PagedDecodeEngine
    api = build_model(mc.program_arch(cfg))
    params = weights_lib.make(cfg, args.seed)
    eng = PagedDecodeEngine(api, params, window=mc.window(cfg),
                            device="cuda", **mix["engine"])
    drv = Driver(eng, keep_steps=False)
    print(json.dumps({"card": torch.cuda.get_device_name(),
                      "workload": args.workload}), flush=True)
    with torch.no_grad():
        cell.warm_buckets(drv, eng, cfg["vocab_size"], args.seed)
        base = traffic_lib.Traffic(mix, cfg["vocab_size"], args.seed)
        for ctx in base.contexts:
            drv.submit(ctx, 1, time.perf_counter())
        drv.drain()
        rates = [float(r) for r in args.rates.split(",")]
        if args.fill:
            m = dict(mix, rate_rps=rates[0], warm_s=args.fill)
            t = traffic_lib.Traffic(m, cfg["vocab_size"], args.seed + 1000)
            t.contexts = base.contexts
            cell._window(cell.Loop(drv, t, m), m, 1.0, False,
                         torch.device("cuda"))
            drv.drain()
            print(json.dumps({"filled_s": args.fill,
                              "stats": {k: eng.stats()[k] for k in (
                                  "cache_evictions", "swap_outs",
                                  "block_utilization")}}), flush=True)
        for i, rate in enumerate(rates):
            m = dict(mix, rate_rps=rate, warm_s=args.warm)
            # fresh suffixes at every rate (the same seed would send the
            # previous rate's prompts again, all cached), the same contexts
            t = traffic_lib.Traffic(m, cfg["vocab_size"], args.seed + 1 + i)
            t.contexts = base.contexts
            loop = cell.Loop(drv, t, m)
            out = cell._window(loop, m, args.seconds, False,
                               torch.device("cuda"))
            w = out.window
            walls = [s.t1 - s.t0 for s in out.steps]
            tt = stats.ttfts(out.window_reqs, out.t_close, w)
            print(json.dumps({
                "rate_rps": rate,
                "waiting_open": out.stats_open["waiting"],
                "waiting_close": out.stats_close["waiting"],
                "due": out.attempted,
                "finished": sum(1 for r in out.requests
                                if r.done is not None and w[0] <= r.done
                                < w[1]),
                "ttft_p50_ms": 1e3 * stats.percentile(tt, 50),
                "ttft_p95_ms": 1e3 * stats.percentile(tt, 95),
                "tpot_p95_ms": 1e3 * (stats.percentile(
                    stats.tpots(out.requests, w), 95) or 0.0),
                "step_ms": 1e3 * sum(walls) / max(len(walls), 1),
                "evictions": out.stats_close["cache_evictions"]
                - out.stats_open["cache_evictions"],
                "tokens_per_step": sum(s.scheduled for s in out.steps)
                / max(len(out.steps), 1)}), flush=True)
            drv.drain()
    return 0


if __name__ == "__main__":
    sys.exit(main())
