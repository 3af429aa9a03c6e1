"""Fused SeparableConv2d body: ``[act](pw1x1(act(dw3x3(x) + b_dw)) [+noise])``.

Port of `migan_tpu/ops/pallas/sepconv.py::fused_block` and
`migan_tpu/ops/pallas/packedblock.py::fused_block_packed`: one CUDA kernel
(`csrc/sepconv.cu`, pointwise product on tensor cores) on contiguous NHWC
tensors, with `final_act=False` for a synthesis conv1's low-res half, whose
activation follows the up-sample. Its launch geometry comes from
`plan.launch_plan`. On a CPU tensor the wrapper runs `sepconv_plain`, the
same function in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..bias_act import lrelu_agc
from ..conv import conv2d
from . import _build, plan

ACT = lrelu_agc(alpha=0.2, gain="sqrt_2", clamp=256)
COUNTER = _build.LaunchCounter("sepconv")


def sepconv_plain(x: torch.Tensor, w_dw: torch.Tensor, b_dw: torch.Tensor,
                  w_pw: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  final_act: bool = True) -> torch.Tensor:
    """x [N,H,W,C], w_dw [3,3,C], b_dw [C], w_pw [C,O], noise [H,W]."""
    c = x.shape[-1]
    y = conv2d(x, w_dw[:, :, None, :], padding=1, groups=c) + b_dw
    y = conv2d(ACT(y), w_pw[None, None])
    if noise is not None:
        y = y + noise[None, :, :, None]
    return ACT(y) if final_act else y


def fused_block(x: torch.Tensor, w_dw: torch.Tensor, b_dw: torch.Tensor,
                w_pw: torch.Tensor, noise: Optional[torch.Tensor] = None,
                final_act: bool = True) -> torch.Tensor:
    """Fused dw3x3 + b -> act -> pw1x1 (+noise) (-> act).

    x: [N, H, W, C] contiguous; w_dw: [3, 3, C]; b_dw: [C]; w_pw: [C, O];
    noise: optional [H, W] per-pixel scalar (already scaled by its
    strength), broadcast over batch and channels. All of one dtype; C and
    O multiples of 8 on CUDA. Returns [N, H, W, O].
    """
    if x.device.type == "cpu":
        return sepconv_plain(x, w_dw, b_dw, w_pw, noise, final_act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: unsupported device {x.device}")
    n, h, w, c = x.shape
    o = w_pw.shape[-1]
    if (w_dw.shape != (3, 3, c) or b_dw.shape != (c,)
            or w_pw.shape != (c, o)
            or (noise is not None and noise.shape != (h, w))):
        raise ValueError(
            f"fused_block: shapes x {tuple(x.shape)} w_dw "
            f"{tuple(w_dw.shape)} b_dw {tuple(b_dw.shape)} w_pw "
            f"{tuple(w_pw.shape)} noise "
            f"{None if noise is None else tuple(noise.shape)}")
    _build.check_cuda_args("fused_block", x.dtype, x.device, x=x,
                           w_dw=w_dw, b_dw=b_dw, w_pw=w_pw, noise=noise)
    plan.check_tc_args("fused_block", x, w_pw)
    p = plan.launch_plan("sepconv", n, h, w, o, x.dtype)
    lib = _build.load_library()
    out = torch.empty((n, h, w, o), dtype=x.dtype, device=x.device)
    err = lib.migan_sepconv(
        _build.DTYPE_CODES[x.dtype], p.config, p.blocks, p.threads,
        p.smem_bytes, x.data_ptr(), w_dw.data_ptr(),
        b_dw.data_ptr(), w_pw.data_ptr(), _build.ptr(noise), out.data_ptr(),
        n, h, w, c, o, int(final_act), _build.stream_handle(x.device))
    _build.raise_on_error("fused_block", err)
    COUNTER.add()
    return out
