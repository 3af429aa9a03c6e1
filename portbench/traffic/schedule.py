"""Open-loop arrivals and the nearest-rank percentile.

A Poisson mix at `rate` over `seconds` sends round(rate * seconds)
requests. Its gaps are the exponential distribution's quantiles at the
midpoints (i + 0.5) / n, so every seed gets the same set of gaps, and so
the same offered load, in its own order.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def poisson_gaps(rate: float, seconds: float, seed: int) -> np.ndarray:
    n = max(1, round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return np.random.default_rng([seed % 2 ** 63, 3]).permutation(gaps)


def due_times(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Offsets from the window's start at which each request is due: the
    first at 0, then the gaps summed."""
    gaps = poisson_gaps(rate, seconds, seed)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-quantile, q in (0, 1], of any values."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(q * len(s)) - 1)]


def latencies(due: Sequence[float], done: Sequence[float]) -> List[float]:
    """Each request's latency from when it was due, not from when it was
    sent, so a late sender or a stalled server counts in full."""
    return [d1 - d0 for d0, d1 in zip(due, done)]
