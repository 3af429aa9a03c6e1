"""Linear (triangle-kernel) resampling with the arithmetic of JAX's
`jax.image.scale_and_translate` and `jax.image.resize`.

The port's pipeline (`export/pipeline.py`) and its Inception detector
(`evalx/inception.py`) are held against JAX functions that resample this
way, so the port builds the same dense weight matrix per axis and applies
it with two `einsum`s. `F.interpolate` and `grid_sample` are not used:
their edges differ, their antialiased kernel differs at the boundary, and
they cannot take a data-dependent box as a traced scale and translation.

For output index i of an axis with `scale` s and `translation` t, the
sample position in the input is ``(i + 0.5 - t) / s - 0.5`` (computed as
JAX does: ``(i + 0.5) / s - t / s - 0.5`` in float32); input pixel j
weighs ``max(0, 1 - |sample - j| / k)`` with ``k = max(1 / s, 1)`` when
antialiasing and 1 otherwise; each column is divided by its sum; a column
whose sample lies outside ``[-0.5, in - 0.5]`` is zero.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

Scalar = Union[float, torch.Tensor]

_EPS32 = float(np.finfo(np.float32).eps)


def weight_matrix(in_size: int, out_size: int, scale: Scalar,
                  translation: Scalar, antialias: bool,
                  device=None) -> torch.Tensor:
    """The float32 [in_size, out_size] resampling matrix of one axis.
    `scale` and `translation` may be 0-dim float32 tensors (a box that is
    data-dependent) or Python numbers (rounded to float32 first, as JAX
    does with a weakly typed scalar)."""
    if isinstance(scale, torch.Tensor):
        device = scale.device
    f32 = dict(dtype=torch.float32, device=device)
    scale = torch.as_tensor(scale, **f32)
    translation = torch.as_tensor(translation, **f32)
    inv_scale = 1.0 / scale
    sample = ((torch.arange(out_size, **f32) + 0.5) * inv_scale
              - translation * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(in_size, **f32)[:, None]).abs()
    if antialias:
        x = x / torch.clamp(inv_scale, min=1.0)
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def scale_and_translate(x: torch.Tensor, out_hw, scale, translation,
                        antialias: bool) -> torch.Tensor:
    """`jax.image.scale_and_translate(x, (N, oh, ow, C), (1, 2), scale,
    translation, "linear", antialias)` on NHWC x. scale and translation
    are (y, x) pairs of numbers or 0-dim float32 tensors. The weights take
    x's dtype, as in JAX."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    wy = weight_matrix(h, oh, scale[0], translation[0], antialias,
                       x.device).to(x.dtype)
    wx = weight_matrix(w, ow, scale[1], translation[1], antialias,
                       x.device).to(x.dtype)
    y = torch.einsum("nhwc,hy->nywc", x, wy)
    return torch.einsum("nywc,wx->nyxc", y, wx)


def resize_bilinear(x: torch.Tensor, out_hw, antialias: bool = True
                    ) -> torch.Tensor:
    """`jax.image.resize(x, (N, oh, ow, C), "bilinear", antialias)` on NHWC
    x: an axis whose size does not change is left as it is, and the scale
    of one that does is out / in."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    if h != oh:
        wy = weight_matrix(h, oh, oh / h, 0.0, antialias,
                           x.device).to(x.dtype)
        x = torch.einsum("nhwc,hy->nywc", x, wy)
    if w != ow:
        wx = weight_matrix(w, ow, ow / w, 0.0, antialias,
                           x.device).to(x.dtype)
        x = torch.einsum("nywc,wx->nyxc", x, wx)
    return x
