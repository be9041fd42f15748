"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/``
and the program (``src/repro_torch``).  It needs as many CUDA cards as
the cell asks for and never falls back to the CPU.  The last line of
standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number the check compared, beside its limit); the last
lines of standard error repeat the check's numbers.  See
``bench/README.md``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc libraries live in its git-ignored
    ``src/repro_torch/kernels/build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's, JAX's
    or Flax's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x):
    return x if isinstance(x, (int, str)) or math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench_json["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (src/repro_torch) is not in this checkout: {e}",
              file=sys.stderr)
        return 4
    from bench.harness import cell
    from bench.harness.check import describe

    built = set(os.listdir(_build_dir())) if _build_dir().exists() \
        else set()
    res = cell.run(args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_start=T_START,
                   bench_json=bench_json)
    new = set(os.listdir(_build_dir())) - built \
        if _build_dir().exists() else set()
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 5
    run = res.pop("_run")
    res.pop("_check")
    print("phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     run.phases.items()), file=sys.stderr)
    for v in res["check"].values():
        v["value"] = _finite(v["value"])
    setup = res["metrics"].get("setup_s", {}).get("value")
    if new:
        print(f"this run built {len(new)} kernel libraries: its set-up "
              f"({setup} s) includes their compilation", file=sys.stderr)
    for line in describe(res["check"]):
        print(line, file=sys.stderr)
    print(json.dumps(res))
    return 0


def _build_dir() -> Path:
    return ROOT / "src" / "repro_torch" / "kernels" / "build"


if __name__ == "__main__":
    sys.exit(main())
