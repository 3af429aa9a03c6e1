"""Pad -> zero-insert upsample -> FIR filter -> downsample on NHWC tensors.

Port of `migan_tpu/ops/upfirdn2d.py` (reference torch_utils/ops/upfirdn2d.py,
`_upfirdn2d_ref` at :169-208): zero insertion by reshape + pad, padding or
cropping by `F.pad`, the FIR as a depthwise convolution
(`ops/depthwise.py`) whose stride does the downsampling. Tensors are NHWC
at the boundary; the convs run on the NCHW view of the same memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .depthwise import depthwise_conv2d
from .filters import parse_padding, parse_scaling, filter_size


def _depthwise(y: torch.Tensor, f: torch.Tensor, stride) -> torch.Tensor:
    c = y.shape[1]
    w = f[None, None].expand(c, 1, *f.shape).contiguous()
    return depthwise_conv2d(y, w, stride)


def upfirdn2d(x: torch.Tensor, f: torch.Tensor | None, up=1, down=1,
              padding=0, gain: float = 1.0,
              flip_filter: bool = False) -> torch.Tensor:
    """Pad, upsample, filter and downsample a batch of NHWC images.

    f: prepared FIR filter [fh, fw] or separable [taps] (see
    :func:`filters.setup_filter`), or None for identity. padding is
    (x0, x1, y0, y1) in upsampled space; negative values crop.
    flip_filter: False convolves with f, True correlates.
    Returns contiguous [N, outH, outW, C] with
    outH = (H*upy + pady0 + pady1 - fh) // downy + 1 (likewise W).
    """
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(x.shape)}")
    if f is None:
        f = torch.ones(1, 1)
    upx, upy = parse_scaling(up)
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    n, h, w, c = x.shape

    y = x.permute(0, 3, 1, 2)                                # NCHW view
    if upx > 1 or upy > 1:
        y = y.reshape(n, c, h, 1, w, 1)
        y = F.pad(y, [0, upx - 1, 0, 0, 0, upy - 1])
        y = y.reshape(n, c, h * upy, w * upx)
    y = F.pad(y, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    y = y[:, :, max(-py0, 0):y.shape[2] - max(-py1, 0),
          max(-px0, 0):y.shape[3] - max(-px1, 0)]

    f = f.to(device=x.device, dtype=x.dtype) * (gain ** (f.ndim / 2))
    if not flip_filter:          # F.conv2d correlates
        f = f.flip(list(range(f.ndim)))
    if f.ndim == 2:
        y = _depthwise(y, f, (downy, downx))
    else:                          # separable: x pass, then y pass
        y = _depthwise(y, f[None, :], (1, downx))
        y = _depthwise(y, f[:, None], (downy, 1))
    return y.permute(0, 2, 3, 1).contiguous()


def filter2d(x, f, padding=0, flip_filter: bool = False,
             gain: float = 1.0) -> torch.Tensor:
    """FIR-filter NHWC images; with padding 0 the output has the input's
    size (padding arithmetic of reference upfirdn2d.py:296-304)."""
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2,
         py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter: bool = False,
               gain: float = 1.0) -> torch.Tensor:
    """FIR upsampling; the gain is multiplied by up*up to keep the DC
    level (reference upfirdn2d.py:334-343)."""
    upx, upy = parse_scaling(up)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter: bool = False,
                 gain: float = 1.0) -> torch.Tensor:
    """FIR downsampling (padding arithmetic of reference
    upfirdn2d.py:373-382)."""
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
