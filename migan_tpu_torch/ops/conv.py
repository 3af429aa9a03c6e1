"""Plain grouped 2-D convolution, NHWC x HWIO -> NHWC (port of
`migan_tpu/ops/conv.py::conv2d`), through `F.conv2d` on the NCHW view of
the same memory. This is the plain path that the fused kernels replace."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
           groups: int = 1) -> torch.Tensor:
    """x [N, H, W, Cin], w [kh, kw, Cin // groups, O] -> contiguous
    [N, H', W', O].

    padding: int, (py, px), or ((py0, py1), (px0, px1)). Correlation, as
    torch and lax compute it.
    """
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NHWC x and HWIO w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    elif len(padding) == 2 and isinstance(padding[0], int):
        padding = ((padding[0], padding[0]), (padding[1], padding[1]))
    (py0, py1), (px0, px1) = padding
    y = x.permute(0, 3, 1, 2)
    w = w.permute(3, 2, 0, 1).to(x.dtype)
    if py0 == py1 and px0 == px1:
        y = F.conv2d(y, w, stride=stride, padding=(py0, px0), groups=groups)
    else:
        y = F.conv2d(F.pad(y, [px0, px1, py0, py1]), w, stride=stride,
                     groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()
