"""Fused down-sampling SeparableConv2d:
``act(pw1x1(down2_[1,3,3,1](act(dw3x3(x) + b_dw))))``.

Port of `migan_tpu/ops/pallas/downblock.py::fused_down_block` as one CUDA
kernel (`csrc/downblock.cu`: y once per hi-res pixel, separable FIR,
pointwise product on tensor cores) on contiguous NHWC tensors. Its launch
geometry comes from `plan.launch_plan`. On a CPU tensor the wrapper runs
`downblock_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..conv import conv2d
from ..filters import setup_filter
from ..upfirdn2d import downsample2d
from . import _build, plan
from .sepconv import ACT

COUNTER = _build.LaunchCounter("downblock")
FIR_TAPS = [1, 3, 3, 1]


def downblock_plain(x: torch.Tensor, w_dw: torch.Tensor, b_dw: torch.Tensor,
                    w_pw: torch.Tensor) -> torch.Tensor:
    """x [N,Hh,Wh,C], w_dw [3,3,C], b_dw [C], w_pw [C,O] -> [N,Hh/2,Wh/2,O]."""
    c = x.shape[-1]
    y = ACT(conv2d(x, w_dw[:, :, None, :], padding=1, groups=c) + b_dw)
    y = downsample2d(y, setup_filter(FIR_TAPS, device=x.device), down=2)
    return ACT(conv2d(y, w_pw[None, None]))


def fused_down_block(x: torch.Tensor, w_dw: torch.Tensor,
                     b_dw: torch.Tensor, w_pw: torch.Tensor) -> torch.Tensor:
    """Fused dw3x3 + b -> act -> FIR-down2 -> pw1x1 -> act.

    x: [N, Hh, Wh, C] contiguous, Hh and Wh even; w_dw: [3, 3, C];
    b_dw: [C]; w_pw: [C, O]; all of one dtype; C and O multiples of 8 on CUDA.
    Returns [N, Hh/2, Wh/2, O].
    """
    if x.device.type == "cpu":
        return downblock_plain(x, w_dw, b_dw, w_pw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_down_block: unsupported device {x.device}")
    n, hh, wh, c = x.shape
    o = w_pw.shape[-1]
    if (hh % 2 or wh % 2 or w_dw.shape != (3, 3, c) or b_dw.shape != (c,)
            or w_pw.shape != (c, o)):
        raise ValueError(
            f"fused_down_block: shapes x {tuple(x.shape)} w_dw "
            f"{tuple(w_dw.shape)} b_dw {tuple(b_dw.shape)} w_pw "
            f"{tuple(w_pw.shape)} (H and W must be even)")
    _build.check_cuda_args("fused_down_block", x.dtype, x.device, x=x,
                           w_dw=w_dw, b_dw=b_dw, w_pw=w_pw)
    plan.check_tc_args("fused_down_block", x, w_pw)
    p = plan.launch_plan("downblock", n, hh, wh, o, x.dtype)
    lib = _build.load_library()
    out = torch.empty((n, hh // 2, wh // 2, o), dtype=x.dtype,
                      device=x.device)
    err = lib.migan_downblock(
        _build.DTYPE_CODES[x.dtype], p.config, p.blocks, p.threads,
        p.smem_bytes, x.data_ptr(), w_dw.data_ptr(),
        b_dw.data_ptr(), w_pw.data_ptr(), out.data_ptr(), n, hh, wh, c, o,
        _build.stream_handle(x.device))
    _build.raise_on_error("fused_down_block", err)
    COUNTER.add()
    return out
