"""Reading the device trace of a window.

The kernel families and the busy-interval union are frozen copies of
``repro_torch/launch/profile_serve.py``'s ``_group``, ``ROUTER_KERNELS``
and ``_busy_us``, so that a later change to the program cannot move the
yardstick.  The trace is ``torch.profiler``'s, read from its raw event
list (``kineto_results``), which is far quicker than its per-event
Python objects on a window of many thousands of kernels.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# device kernels of the MoE router (models/moe.py: the softmaxes, top-k
# and its sort, the capacity cumsum, the experts' one-hot), by the names
# the deepseek-moe-16b profiles on an H100 showed (copied from
# profile_serve.ROUTER_KERNELS)
ROUTER_KERNELS = ("softmax_warp_forward", "gatherTopK",
                  "bitonicSortKVInPlace", "tensor_kernel_scan_outer_dim",
                  "_cuda_scatter_fill")


def family(name: str, moe: bool = False) -> str:
    """Kernel family of a device kernel name (copied from
    profile_serve._group): the paged reads (B1-B3, FMA and the bf16
    split sweep with its combine), the GEMMs, with ``moe`` the router,
    and everything else."""
    if any(k in name for k in ("paged_attention_kernel",
                               "paged_split::split_")):
        return "attention"
    if any(k in name for k in ("nvjet", "gemm", "splitKreduce", "cutlass")):
        return "gemm"
    if moe and any(k in name for k in ROUTER_KERNELS):
        return "router"
    return "other"


def busy(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals (copied from
    profile_serve._busy_us)."""
    spans = sorted(intervals)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle (start, end) stretches of [lo, hi] that no interval
    covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Trace:
    """One traced window, times in seconds on the trace's clock:
    device operations (name, start, end) and the harness's own host
    ranges (name, start, end)."""
    ops: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    lo: float
    hi: float

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return busy((s, e) for _, s, e in self.ops)

    def family_s(self, fam: str, moe: bool) -> float:
        return sum(e - s for n, s, e in self.ops if family(n, moe) == fam)

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for n, s, e in self.ops:
            tot[n] = tot.get(n, 0.0) + (e - s)
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v] for n, v in rows]

    def idle_by_host(self, k: int = 10, moe: bool = False) -> List[List]:
        """Idle device time summed by what the host was doing: inside a
        harness range (its name), and there after which kernel family."""
        ranges = sorted(self.host, key=lambda r: r[1])
        ops = sorted(self.ops, key=lambda o: o[1])
        ends = [e for _, _, e in ops]
        tot: Dict[str, float] = {}
        for a, b in gaps(((s, e) for _, s, e in ops), self.lo, self.hi):
            mid = 0.5 * (a + b)
            where = "outside the harness's ranges"
            for name, s, e in ranges:
                if s <= mid <= e:
                    where = name
                    break
                if s > mid:
                    break
            i = bisect.bisect_right(ends, a + 1e-12) - 1
            prev = family(ops[i][0], moe) if i >= 0 else "start"
            key = f"{where}, after {prev}"
            tot[key] = tot.get(key, 0.0) + (b - a)
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v] for n, v in rows]


def _ev_times(e) -> Tuple[float, float]:
    if hasattr(e, "start_ns"):
        s = e.start_ns() * 1e-9
        return s, s + e.duration_ns() * 1e-9
    s = e.start_us() * 1e-6
    return s, s + e.duration_us() * 1e-6


def from_profiler(prof, host_names: Sequence[str]) -> Optional[Trace]:
    """The Trace of a finished ``torch.profiler.profile``: every device
    event (kernels, copies, sets), and the host ranges named in
    ``host_names``.  The window is the span of the harness's
    ``bench.window`` range; the ranges' shadows on the device timeline
    are not device work and are left out."""
    import torch
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        return None
    ops, host = [], []
    lo = hi = None
    cuda = torch.autograd.DeviceType.CUDA
    for e in res.events():
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith("bench."):     # a range's device shadow
                continue
            s, t = _ev_times(e)
            ops.append((name, s, t))
        elif name == "bench.window":
            lo, hi = _ev_times(e)
        elif name in host_names:
            s, t = _ev_times(e)
            host.append((name, s, t))
    if lo is None:
        return None
    ops = [(n, max(s, lo), min(t, hi)) for n, s, t in ops
           if t > lo and s < hi]
    return Trace(ops=ops, host=host, lo=lo, hi=hi)
