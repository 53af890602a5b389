"""Window statistics and device-trace arithmetic of the benchmark."""
from __future__ import annotations

import math
import random
import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of every value, linear between closest ranks."""
    v = sorted(values)
    pos = q / 100.0 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (`statistics.quantiles(values, n=4)`)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                  float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_time(intervals: Iterable[Tuple[float, float]], lo: float,
              hi: float) -> float:
    """Time within [lo, hi] in which at least one interval is open:
    overlapping intervals count once."""
    total = 0.0
    for s, e in merge(intervals):
        total += max(0.0, min(e, hi) - max(s, lo))
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no interval is open."""
    out, t = [], lo
    for s, e in merge(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class Reservoir:
    """A uniform sample of `k` items of a stream of unknown length, drawn
    from `seed` (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.items: list = []

    def offer(self, make) -> None:
        """Offer the stream's next item, made by `make()` only if kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make()
