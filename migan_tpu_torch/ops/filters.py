"""FIR filter preparation for the resampling ops (port of
`migan_tpu/ops/filters.py`; reference torch_utils/ops/upfirdn2d.py:72-116)."""

from __future__ import annotations

import functools

import numpy as np
import torch


def setup_filter(f, gain: float = 1.0, device=None) -> torch.Tensor:
    """Prepare a normalized 2-D FIR filter for :func:`upfirdn2d`.

    f: taps (scalar, 1-D, 2-D or None = identity). A 1-D filter of fewer
    than 8 taps becomes its outer product; a longer one stays separable.
    Returns a float32 tensor [fh, fw] (or [taps] when separable), scaled
    by gain ** (ndim / 2).
    """
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float64)
    if f.ndim not in (0, 1, 2) or f.size == 0:
        raise ValueError(f"bad filter shape {f.shape}")
    if f.ndim == 0:
        f = f[np.newaxis]
    if f.ndim == 1 and f.size < 8:
        f = np.outer(f, f)
    f = f / f.sum() * (gain ** (f.ndim / 2))
    return torch.tensor(f, dtype=torch.float32, device=device)


def device_filter(taps, device=None) -> torch.Tensor:
    """`setup_filter(taps)` on `device`, made once per taps and device and
    shared by every caller, who must not write to it: a CUDA graph cannot
    copy a filter from the host at each forward, it reads this one."""
    return _device_filter(tuple(taps), str(torch.device(device or "cpu")))


@functools.lru_cache(maxsize=None)
def _device_filter(taps: tuple, device: str) -> torch.Tensor:
    return setup_filter(list(taps), device=device)


def parse_scaling(scaling):
    """Normalize an int or (x, y) pair of scaling factors."""
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = (int(s) for s in scaling)
    if sx < 1 or sy < 1:
        raise ValueError(f"bad scaling {scaling}")
    return sx, sy


def parse_padding(padding):
    """Normalize padding to (px0, px1, py0, py1)."""
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def filter_size(f):
    """(fw, fh) of a prepared filter (None = identity 1x1)."""
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])
