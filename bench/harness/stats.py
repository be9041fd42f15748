"""The benchmark's percentile and latency arithmetic."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q`` % of the values at or below it.  None for
    no values."""
    v = sorted(values)
    if not v:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(v)))
    return v[rank - 1]


def ttfts(requests, t_close: float, window) -> List[float]:
    """Seconds from due time to first token of every request due in
    ``window`` (t_open, t_close); a request with no first token counts
    with the time it has waited until ``t_close``."""
    t0, t1 = window
    out = []
    for r in requests:
        if not (t0 <= r.due < t1):
            continue
        first = r.first if r.first is not None else t_close
        out.append(first - r.due)
    return out


def tpots(requests, window) -> List[float]:
    """(last token - first token) / (tokens - 1) of every request whose
    last token came inside ``window``, for those with two tokens or
    more."""
    t0, t1 = window
    return [(r.last - r.first) / (r.n_tokens - 1) for r in requests
            if r.done is not None and t0 <= r.done < t1
            and r.n_tokens >= 2]
