"""Fused up-sampling synthesis block:
``t = act(up2_[1,3,3,1](x_lo) + noise_up) + skip``;
``y = act(pw1x1(act(dw3x3(t) + b_dw)) [+ noise2])``;
optional torgb epilogue ``rgb = y . w_rgb + b_rgb``.

Port of `migan_tpu/ops/pallas/upblock.py::fused_up_block` as one CUDA
kernel (`csrc/upblock.cu`: t once per hi-res pixel of a tile, pointwise
product on tensor cores, torgb summed in a fixed order) on contiguous NHWC
tensors. Its launch geometry comes from `plan.launch_plan`. On a CPU
tensor the wrapper runs `upblock_plain`, the same function in plain
PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..conv import conv2d
from ..filters import setup_filter
from ..upfirdn2d import upsample2d
from . import _build, plan
from .downblock import FIR_TAPS
from .sepconv import ACT

COUNTER = _build.LaunchCounter("upblock")


def _outputs(feat, rgb, emit_features):
    if rgb is None:
        return feat
    return (feat, rgb) if emit_features else rgb


def upblock_plain(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2=None,
                  w_rgb=None, b_rgb=None, emit_features=True):
    """The same outputs as :func:`fused_up_block`, in plain PyTorch."""
    t = upsample2d(x_lo, setup_filter(FIR_TAPS, device=x_lo.device), up=2)
    t = ACT(t + noise_up[None, :, :, None]) + skip
    c = t.shape[-1]
    y = ACT(conv2d(t, w_dw[:, :, None, :], padding=1, groups=c) + b_dw)
    y = conv2d(y, w_pw[None, None])
    if noise2 is not None:
        y = y + noise2[None, :, :, None]
    y = ACT(y)
    rgb = None if w_rgb is None else conv2d(y, w_rgb[None, None]) + b_rgb
    return _outputs(y, rgb, emit_features)


def fused_up_block(x_lo: torch.Tensor, skip: torch.Tensor,
                   noise_up: torch.Tensor, w_dw: torch.Tensor,
                   b_dw: torch.Tensor, w_pw: torch.Tensor,
                   noise2: Optional[torch.Tensor] = None,
                   w_rgb: Optional[torch.Tensor] = None,
                   b_rgb: Optional[torch.Tensor] = None,
                   emit_features: bool = True):
    """Fused up2 + noise + act + skip + dw3x3/pw1x1 (+noise2) + act
    (+ torgb).

    x_lo: [N, Hl, Wl, C]; skip: [N, 2Hl, 2Wl, C]; noise_up, noise2:
    [2Hl, 2Wl] pre-scaled noise; w_dw: [3, 3, C]; b_dw: [C]; w_pw: [C, O];
    w_rgb: [O, 3] and b_rgb: [3] for the torgb epilogue. All contiguous and
    of one dtype; C and O multiples of 8 on CUDA.

    Returns the features [N, 2Hl, 2Wl, O]; with w_rgb the tuple
    (features, rgb [N, 2Hl, 2Wl, 3]), or only rgb when emit_features is
    False (the top level, where nothing else reads the features).
    """
    if (w_rgb is None) != (b_rgb is None):
        raise ValueError("fused_up_block: pass both w_rgb and b_rgb")
    if w_rgb is None and not emit_features:
        raise ValueError("fused_up_block: no output requested")
    if x_lo.device.type == "cpu":
        return upblock_plain(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2,
                             w_rgb, b_rgb, emit_features)
    if x_lo.device.type != "cuda":
        raise ValueError(f"fused_up_block: unsupported device {x_lo.device}")
    n, hl, wl, c = x_lo.shape
    o = w_pw.shape[-1]
    hw = (2 * hl, 2 * wl)
    if (skip.shape != (n, *hw, c) or noise_up.shape != hw
            or w_dw.shape != (3, 3, c) or b_dw.shape != (c,)
            or w_pw.shape != (c, o)
            or (noise2 is not None and noise2.shape != hw)
            or (w_rgb is not None and (w_rgb.shape != (o, 3)
                                       or b_rgb.shape != (3,)))):
        raise ValueError(
            f"fused_up_block: shapes x_lo {tuple(x_lo.shape)} skip "
            f"{tuple(skip.shape)} noise_up {tuple(noise_up.shape)} w_dw "
            f"{tuple(w_dw.shape)} b_dw {tuple(b_dw.shape)} w_pw "
            f"{tuple(w_pw.shape)}")
    _build.check_cuda_args("fused_up_block", x_lo.dtype, x_lo.device,
                           x_lo=x_lo, skip=skip, noise_up=noise_up,
                           w_dw=w_dw, b_dw=b_dw, w_pw=w_pw, noise2=noise2,
                           w_rgb=w_rgb, b_rgb=b_rgb)
    plan.check_tc_args("fused_up_block", x_lo, w_pw)
    plan.check_tc_args("fused_up_block", skip, w_pw)
    p = plan.launch_plan("upblock", n, hl, wl, o, x_lo.dtype)
    lib = _build.load_library()
    dev = x_lo.device
    feat = (torch.empty((n, *hw, o), dtype=x_lo.dtype, device=dev)
            if emit_features else None)
    rgb = part = None
    if w_rgb is not None:
        rgb = torch.empty((n, *hw, 3), dtype=x_lo.dtype, device=dev)
        if p.out_tiles > 1:
            # each output tile's rgb partial sums, added in tile order
            part = torch.empty((p.out_tiles, n, *hw, 3),
                               dtype=torch.float32, device=dev)
    err = lib.migan_upblock(
        _build.DTYPE_CODES[x_lo.dtype], p.config, p.blocks, p.threads,
        p.smem_bytes, x_lo.data_ptr(), skip.data_ptr(), noise_up.data_ptr(),
        w_dw.data_ptr(), b_dw.data_ptr(), w_pw.data_ptr(), _build.ptr(noise2),
        _build.ptr(w_rgb), _build.ptr(b_rgb), _build.ptr(feat),
        _build.ptr(rgb), _build.ptr(part), n, hl, wl, c, o,
        _build.stream_handle(dev))
    _build.raise_on_error("fused_up_block", err)
    COUNTER.add()
    return _outputs(feat, rgb, emit_features)
