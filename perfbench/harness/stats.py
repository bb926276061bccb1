"""The arithmetic of the end-to-end and device metrics, on plain records:
rates over all the work and all the time of the window, a tail over every
call, and the device's busy time as the union of its kernels' intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def rate(work: Sequence[float], window_s: float) -> float:
    """All the work completed in the window over the window's seconds."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return float(sum(work)) / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q ≤ 100) of every value."""
    if not values:
        raise ValueError("no value")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[k - 1])


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_pct(busy_s: float, window_s: float) -> float:
    """The share of the window in which no operation ran on the device."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return 100.0 * (1.0 - busy_s / window_s)


def gaps(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle (start, end) gaps between the union's pieces."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out
