"""Fused down-sampling SeparableConv2d:
``act(pw1x1(down2_[1,3,3,1](act(dw3x3(x) + b_dw))))``.

Port of `migan_tpu/ops/pallas/downblock.py::fused_down_block` as one CUDA
kernel (`csrc/downblock.cu`: y once per hi-res pixel, separable FIR,
pointwise product on tensor cores) on contiguous NHWC tensors. Its launch
geometry comes from `plan.launch_plan`. The `torch.library` custom op
`migan::fused_down_block` is the ctypes launch on CUDA (`launch.launch`
of `KERNEL`), `downblock_plain` (the same function in plain PyTorch) on
the CPU, and a fake implementation for `torch.export`; the wrapper calls
it while something traces or records the call, and the launch or
`downblock_plain` directly otherwise (`launch.call`).
"""

from __future__ import annotations

import torch

from ..conv import conv2d
from ..filters import setup_filter
from ..upfirdn2d import downsample2d
from . import launch, plan
from .sepconv import ACT

OP = "migan::fused_down_block"
FIR_TAPS = [1, 3, 3, 1]


def downblock_plain(x: torch.Tensor, w_dw: torch.Tensor, b_dw: torch.Tensor,
                    w_pw: torch.Tensor) -> torch.Tensor:
    """x [N,Hh,Wh,C], w_dw [3,3,C], b_dw [C], w_pw [C,O] -> [N,Hh/2,Wh/2,O]."""
    c = x.shape[-1]
    y = ACT(conv2d(x, w_dw[:, :, None, :], padding=1, groups=c) + b_dw)
    y = downsample2d(y, setup_filter(FIR_TAPS, device=x.device), down=2)
    return ACT(conv2d(y, w_pw[None, None]))


def _check(x, w_dw, b_dw, w_pw) -> None:
    """Every check of a launch: raise on what the kernel does not take."""
    n, hh, wh, c = x.shape
    o = w_pw.shape[-1]
    if (hh % 2 or wh % 2 or w_dw.shape != (3, 3, c) or b_dw.shape != (c,)
            or w_pw.shape != (c, o)):
        raise ValueError(
            f"fused_down_block: shapes x {tuple(x.shape)} w_dw "
            f"{tuple(w_dw.shape)} b_dw {tuple(b_dw.shape)} w_pw "
            f"{tuple(w_pw.shape)} (H and W must be even)")
    launch.check_cuda_args("fused_down_block", x.dtype, x.device, x=x,
                           w_dw=w_dw, b_dw=b_dw, w_pw=w_pw)
    plan.check_tc_args("fused_down_block", x, w_pw)


def _layout(key):
    """(plan, mode, sizes, outputs) of a key whose checks passed."""
    (n, hh, wh, c), _, _, (_, o), dtype, _ = key
    p = plan.launch_plan("downblock", n, hh, wh, o, dtype)
    return p, (), (n, hh, wh, c, o), (((n, hh // 2, wh // 2, o), None),)


# the entry point's pointers: x, w_dw, b_dw, w_pw, then the output
KERNEL = launch.Kernel("downblock", "fused_down_block", _check, _layout,
                       tensors=(0, 1, 2, 3), ins=(0, 1, 2, 3),
                       aligned=(0, 3), returns=0)


@torch.library.custom_op(OP, mutates_args=(), device_types="cuda")
def fused_down_block_op(x: torch.Tensor, w_dw: torch.Tensor,
                        b_dw: torch.Tensor, w_pw: torch.Tensor
                        ) -> torch.Tensor:
    return launch.launch(KERNEL, (x, w_dw, b_dw, w_pw))


fused_down_block_op.register_kernel("cpu")(downblock_plain)


@fused_down_block_op.register_fake
def _(x, w_dw, b_dw, w_pw):
    n, hh, wh, _ = x.shape
    return x.new_empty((n, hh // 2, wh // 2, w_pw.shape[-1]))


def fused_down_block(x: torch.Tensor, w_dw: torch.Tensor,
                     b_dw: torch.Tensor, w_pw: torch.Tensor) -> torch.Tensor:
    """Fused dw3x3 + b -> act -> FIR-down2 -> pw1x1 -> act.

    x: [N, Hh, Wh, C] contiguous, Hh and Wh even; w_dw: [3, 3, C];
    b_dw: [C]; w_pw: [C, O]; all of one dtype; C and O multiples of 8 on CUDA.
    Returns [N, Hh/2, Wh/2, O]. CPU tensors take the plain version.
    """
    return launch.call(KERNEL, fused_down_block_op, downblock_plain,
                       (x, w_dw, b_dw, w_pw))
