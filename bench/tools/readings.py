"""The readings a cell's limits are set from.

    python3 bench/tools/readings.py --workload <cell> --seconds 10 \\
        --seeds 1,2,3 [--control-seeds 1,2,3] \\
        [--fault lane|token --fault-seeds 4,5,6] [--detail]

Runs the cell once for each seed in one process (short windows at the
cell's own load), and prints per seed every number of the check's
statistics (``check.STATISTICS``), whether the cell's limits name it or
not.  On the control seeds it also prints the float8 reference's
numbers in the program's place on the same sample, and the check's
verdict on them.  On the fault seeds the program runs with a fault
planted once the window has closed, before the check reads it:

* ``lane``: one block of the lane with the most tokens still to serve
  holds another lane's keys and values at every layer, as a wrong
  block-table entry would make it read;
* ``token``: the first token emitted after the window, in one lane, is
  altered (the next id) where it is produced.

The lower reading of a number is the largest the program gives over the
seeds, the upper the smallest the control gives; ``PERF.md`` keeps both
beside the limit set between them.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench.harness import cell  # noqa: E402
from bench.harness import check as check_lib  # noqa: E402


def _numbers(got: dict) -> dict:
    return {k: stat(got) for k, stat in check_lib.STATISTICS.items()}


def _detail(r, n_layers: int) -> dict:
    out = {}
    if "fresh_segments" in r:
        out["fresh_segments"] = int(np.sum(r["fresh_segments"]))
    for who in ("", "control_"):
        g = r.get(who + "gap")
        if g is not None and np.size(g):
            out[who + "gap_q50_q90_q99"] = np.quantile(
                g, [0.5, 0.9, 0.99]).tolist()
            out[who + "gap_nonzero_share"] = float(np.mean(g > 0))
            out[who + "rank_q50_q99"] = np.quantile(
                r[who + "rank"], [0.5, 0.99]).tolist()
        for k in ("kv_row_err", "ctx_kv_row_err"):
            e = r.get(who + k)
            if e is not None and np.size(e):
                out[who + k + "_max"] = float(np.max(e))
    e = r.get("kv_err")
    if e is not None and np.size(e):
        per = np.asarray(e).reshape(-1, n_layers, 2).max(axis=(0, 2))
        out["kv_err_by_layer"] = [round(float(x), 5) for x in per]
    return out


def plant(fault: str):
    """Wrap ``cell._replay`` so that ``fault`` strikes the program once
    the window has closed; returns a function that undoes it."""
    from repro_torch.serving import engine as eng_mod
    real_replay, real_emit = cell._replay, eng_mod._emit_token
    armed = {"on": False}

    def emit(engine, req, tok):
        if armed["on"]:
            armed["on"] = False
            tok = (int(tok) + 1) % engine.api.cfg.vocab_size
        return real_emit(engine, req, tok)

    def replay(loop, cfg, params, mix, device, control):
        engine = loop.drv.engine
        if fault == "lane":
            bs = engine.cache["scan"]["k"].shape[2]
            live = sorted((r for r in engine.scheduler.running
                           if r.cursor > bs),
                          key=lambda r: (len(r.generated) - r.max_new_tokens,
                                         -r.cursor))
            victim, donor = live[0], live[-1]
            bad = engine.kv.padded_table(victim.request_id)[
                victim.cursor // bs // 2]
            src = engine.kv.padded_table(donor.request_id)[0]
            for pool in (engine.cache["scan"]["k"],
                         engine.cache["scan"]["v"]):
                pool[:, int(bad)] = pool[:, int(src)]
        else:
            armed["on"] = True
        return real_replay(loop, cfg, params, mix, device, control)

    cell._replay = replay
    if fault == "token":
        eng_mod._emit_token = emit

    def undo():
        cell._replay = real_replay
        eng_mod._emit_token = real_emit
    return undo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=("lane", "token"), default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--detail", action="store_true",
                    help="also print the gaps' and ranks' quantiles and "
                    "the keys' and values' errors")
    args = ap.parse_args(argv)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]
    ctl = set(seeds(args.control_seeds))
    runs = [(s, None) for s in seeds(args.seeds)] + \
        [(s, args.fault) for s in seeds(args.fault_seeds)]
    print(json.dumps({"card": torch.cuda.get_device_name()}), flush=True)
    for seed, fault in runs:
        t0 = time.perf_counter()
        undo = plant(fault) if fault else (lambda: None)
        try:
            res = cell.run(args.workload, seed, args.seconds, False,
                           control=fault is None and seed in ctl)
        finally:
            undo()
        chk = res["_check"]
        r = chk["readings"]
        row = {"seed": seed, "fault": fault, "correct": res["correct"],
               "compared": {k: v["value"]
                            for k, v in chk["numbers"].items()},
               "numbers": _numbers(r), "run_s": time.perf_counter() - t0}
        if "control" in chk:
            low = {k[len("control_"):]: v for k, v in r.items()
                   if k.startswith("control_")}
            row["control_correct"] = chk["control"]["correct"]
            row["control_numbers"] = _numbers(low)
        if args.detail:
            row.update(_detail(r, res["_run"].cfg["num_hidden_layers"]))
        print(json.dumps(row), flush=True)
        del res, chk, r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
