"""The single-device serving step of two checkouts on one card, in turns:
``python -m repro_torch.launch.ab_serve --other DIR [--rounds 1]``.

``DIR`` is another checkout of this repo (for example the parent commit,
unpacked with ``git archive``).  Each turn is a fresh process whose
``PYTHONPATH`` is one checkout's ``src``: it builds the arch at its
published width (gemma-7b by default, random bf16 weights from a seed),
drains ``profile_serve``'s shared-prefix fleet once to warm up, then
``--drains`` more times through the default ``PagedDecodeEngine``, and
reports the wall ms a step of each.  The turns run other, this, this,
other per round, so a drift of the shared host's clock over the call
weighs on both sides alike.  Prints the card's name and power limit,
every turn's readings and each side's median.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[3]


def _worker(arch: str, drains: int, seed: int) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import serve_fleet
    from repro_torch.models.api import build_model
    api = build_model(get_config(arch))
    params = api.init(seed=seed, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        serve_fleet(api, params, seed=seed)
        ms = []
        for _ in range(drains):
            eng, _, wall = serve_fleet(api, params, seed=seed)
            ms.append(wall / eng.steps * 1e3)
    print(json.dumps({"ms_per_step": ms, "steps": eng.steps}), flush=True)


def _turn(tree: Path, args) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree / "src")}
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         "--arch", args.arch, "--drains", str(args.drains),
         "--seed", str(args.seed)],
        env=env, capture_output=True, text=True, check=True,
        timeout=args.turn_timeout)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns other, this, this, other")
    ap.add_argument("--drains", type=int, default=3,
                    help="timed drains a turn, after one warm-up drain")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn-timeout", type=float, default=600)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.arch, args.drains, args.seed)
        return
    if args.other is None:
        ap.error("--other is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"other": Path(args.other).resolve(), "this": THIS}
    got = {"other": [], "this": []}
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            r = _turn(trees[side], args)
            got[side].extend(r["ms_per_step"])
            print(f"[{side}] {trees[side]}: steps={r['steps']} ms/step "
                  + ", ".join(f"{m:.3f}" for m in r["ms_per_step"])
                  + f" [{card}]", flush=True)
    med = {side: statistics.median(ms) for side, ms in got.items()}
    print(f"{args.arch} single-device default layout, median ms/step: "
          f"other {med['other']:.3f}, this {med['this']:.3f} "
          f"(this / other {med['this'] / med['other']:.4f}) [{card}]",
          flush=True)
    print(json.dumps({"card": card, "ms_per_step": got, "median": med}))


if __name__ == "__main__":
    main()
