"""Training telemetry: scalar stats with moment accumulation (port of
`migan_tpu/utils/stats.py`; reference torch_utils/training_stats.py).

`report(name, value)` accumulates [count, sum, sum of squares] per name;
a `Collector` snapshot gives the mean and std since its last update.
Values arrive as Python floats or tensors (moved to the host here);
non-finite values are dropped, as the reference does. Under data
parallelism a step's stats are its ranks' means (`mean_across_ranks`)
before they are reported, so that they read as one process's over the
global batch.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np


def _host(value) -> np.ndarray:
    if hasattr(value, "detach"):
        value = value.detach().to("cpu", dtype=value.dtype).double().numpy()
    return np.asarray(value, np.float64).reshape(-1)


def mean_across_ranks(stats: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    """Each scalar stat averaged over the ranks of the process group (one
    all-reduce in float64; every rank passes the same names in the same
    order), as floats; without a group, the values as floats."""
    import torch

    from .. import parallel

    names = list(stats)
    if not parallel.is_initialized():
        return {k: float(stats[k]) for k in names}
    dev = parallel.collective_device()
    v = torch.stack([torch.as_tensor(stats[k]).to(dev, torch.float64)
                     for k in names])
    return dict(zip(names, parallel.all_reduce_mean([v])[0].tolist()))


class StatsRegistry:
    def __init__(self):
        self._moments: Dict[str, np.ndarray] = {}

    def report(self, name: str, value) -> None:
        v = _host(value)
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        m = self._moments.setdefault(name, np.zeros(3, np.float64))
        m += np.array([v.size, v.sum(), np.square(v).sum()])

    def report_dict(self, stats: Dict[str, float]) -> None:
        for k, v in stats.items():
            self.report(k, v)

    def pop(self) -> Dict[str, np.ndarray]:
        out = self._moments
        self._moments = {}
        return out


_default_registry = StatsRegistry()


def report(name: str, value) -> None:
    _default_registry.report(name, value)


def report0(name: str, value) -> None:
    """Report from the first process only (reference
    training_stats.py:103-109): rank 0 of `torch.distributed` when a
    process group is up, else this process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_rank() == 0:
        report(name, value)


class Collector:
    """Snapshot mean/std per matching stat (reference :143-232)."""

    def __init__(self, regex: str = ".*",
                 registry: Optional[StatsRegistry] = None):
        self._regex = re.compile(regex)
        self._registry = registry or _default_registry
        self._cumulative: Dict[str, np.ndarray] = {}
        self._last: Dict[str, np.ndarray] = {}

    def update(self) -> None:
        deltas = self._registry.pop()
        self._last = {}
        for name, d in deltas.items():
            if not self._regex.fullmatch(name):
                continue
            c = self._cumulative.setdefault(name, np.zeros(3, np.float64))
            c += d
            self._last[name] = d

    def names(self):
        return list(self._last.keys())

    def mean(self, name: str) -> float:
        m = self._last.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._last.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        mean = m[1] / m[0]
        var = max(m[2] / m[0] - mean * mean, 0.0)
        return float(np.sqrt(var))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"num": float(self._last[name][0]),
                       "mean": self.mean(name), "std": self.std(name)}
                for name in self._last}


def default_collector(regex: str = ".*") -> Collector:
    return Collector(regex)
