"""Fused SeparableConv2d body:
``[act](pw1x1(act(dw3x3(z) + b_dw)) [+noise])`` with
``z = x (+ skip)``, or ``z = act((x (+ skip)) . w_pre + b_pre)`` with the
pointwise prologue.

Port of `migan_tpu/ops/pallas/sepconv.py::fused_block` and
`migan_tpu/ops/pallas/packedblock.py::fused_block_packed`: one CUDA kernel
(`csrc/sepconv.cu`, pointwise product on tensor cores) on contiguous NHWC
tensors, with `final_act=False` for a synthesis conv1's low-res half, whose
activation follows the up-sample, and the JAX function's `skip` and
`w_pre`/`b_pre` options (the prologue at any input width, which covers
the TPU's 128-lane `pre_g` layout of it). Its launch geometry comes from
`plan.launch_plan`.

The `torch.library` custom op `migan::fused_block` keeps the kernel in
the programs `torch.export` traces: its CUDA implementation is the ctypes
launch (`launch.launch` of `KERNEL`, this kernel's launch data), its CPU
implementation `sepconv_plain`, the same function in plain PyTorch, and
its fake implementation gives the output's shape. The wrapper calls the
op only while something traces or records the call, and the launch or
`sepconv_plain` directly otherwise (`launch.call`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..bias_act import lrelu_agc
from ..conv import conv2d
from . import launch, plan

ACT = lrelu_agc(alpha=0.2, gain="sqrt_2", clamp=256)
OP = "migan::fused_block"


def check_options(name: str, x: torch.Tensor, w_dw: torch.Tensor,
                  skip: Optional[torch.Tensor], w_pre: Optional[torch.Tensor],
                  b_pre: Optional[torch.Tensor]) -> None:
    """Raise on an unpaired w_pre / b_pre, or a skip or prologue whose
    shape does not fit x [N,H,W,Cin] and the dw stage's C channels."""
    if (w_pre is None) != (b_pre is None):
        raise ValueError(f"{name}: pass both w_pre and b_pre")
    if skip is not None and skip.shape != x.shape:
        raise ValueError(f"{name}: shapes skip {tuple(skip.shape)} and x "
                         f"{tuple(x.shape)} differ")
    c = w_dw.shape[-1]
    if w_pre is not None and (w_pre.shape != (x.shape[-1], c)
                              or b_pre.shape != (c,)):
        raise ValueError(f"{name}: shapes w_pre {tuple(w_pre.shape)} b_pre "
                         f"{tuple(b_pre.shape)}, expected "
                         f"({x.shape[-1]}, {c}) and ({c},)")


def sepconv_plain(x: torch.Tensor, w_dw: torch.Tensor, b_dw: torch.Tensor,
                  w_pw: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  final_act: bool = True,
                  skip: Optional[torch.Tensor] = None,
                  w_pre: Optional[torch.Tensor] = None,
                  b_pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N,H,W,Cin], w_dw [3,3,C], b_dw [C], w_pw [C,O], noise [H,W];
    skip [N,H,W,Cin] added to x first; w_pre [Cin,C] and b_pre [C] the
    prologue act(z . w_pre + b_pre) (Cin = C without it), as
    `migan_tpu/ops/pallas/sepconv.py::_xla_block`."""
    check_options("sepconv_plain", x, w_dw, skip, w_pre, b_pre)
    if skip is not None:
        x = x + skip
    if w_pre is not None:
        x = ACT(conv2d(x, w_pre[None, None]) + b_pre)
    c = x.shape[-1]
    y = conv2d(x, w_dw[:, :, None, :], padding=1, groups=c) + b_dw
    y = conv2d(ACT(y), w_pw[None, None])
    if noise is not None:
        y = y + noise[None, :, :, None]
    return ACT(y) if final_act else y


def _check(x, w_dw, b_dw, w_pw, noise, final_act, skip, w_pre,
           b_pre) -> None:
    """Every check of a launch: raise on what the kernel does not take."""
    n, h, w, cin = x.shape
    c = w_dw.shape[-1]
    o = w_pw.shape[-1]
    check_options("fused_block", x, w_dw, skip, w_pre, b_pre)
    if (w_dw.shape != (3, 3, c) or b_dw.shape != (c,)
            or w_pw.shape != (c, o) or (w_pre is None and cin != c)
            or (noise is not None and noise.shape != (h, w))):
        raise ValueError(
            f"fused_block: shapes x {tuple(x.shape)} w_dw "
            f"{tuple(w_dw.shape)} b_dw {tuple(b_dw.shape)} w_pw "
            f"{tuple(w_pw.shape)} noise "
            f"{None if noise is None else tuple(noise.shape)}")
    launch.check_cuda_args("fused_block", x.dtype, x.device, x=x,
                           w_dw=w_dw, b_dw=b_dw, w_pw=w_pw, noise=noise,
                           skip=skip, w_pre=w_pre, b_pre=b_pre)
    plan.check_tc_args("fused_block", x, w_pw, prologue=w_pre is not None)
    if skip is not None:
        plan.check_tc_args("fused_block", skip, w_pw,
                           prologue=w_pre is not None)


def _layout(key):
    """(plan, mode, sizes, outputs) of a key whose checks passed."""
    (n, h, w, cin), (_, _, c), _, (_, o), _, final_act, skip, w_pre, _, \
        dtype, _ = key
    mode = (plan.SEP_PROLOGUE if w_pre is not None else
            plan.SEP_SKIP if skip is not None else plan.SEP_PLAIN)
    p = plan.launch_plan("sepconv", n, h, w, o, dtype, mode=mode, cin=cin)
    return p, (mode,), (n, h, w, cin, c, o, int(final_act)), \
        (((n, h, w, o), None),)


# the entry point's pointers: x, skip, w_pre, b_pre, w_dw, b_dw, w_pw,
# noise, then the output
KERNEL = launch.Kernel("sepconv", "fused_block", _check, _layout,
                       tensors=(0, 1, 2, 3, 4, 6, 7, 8),
                       ins=(0, 6, 7, 8, 1, 2, 3, 4), aligned=(0, 3, 6),
                       returns=0)


@torch.library.custom_op(OP, mutates_args=(), device_types="cuda")
def fused_block_op(x: torch.Tensor, w_dw: torch.Tensor, b_dw: torch.Tensor,
                   w_pw: torch.Tensor, noise: Optional[torch.Tensor],
                   final_act: bool, skip: Optional[torch.Tensor] = None,
                   w_pre: Optional[torch.Tensor] = None,
                   b_pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    return launch.launch(KERNEL, (x, w_dw, b_dw, w_pw, noise, final_act,
                                  skip, w_pre, b_pre))


fused_block_op.register_kernel("cpu")(sepconv_plain)


@fused_block_op.register_fake
def _(x, w_dw, b_dw, w_pw, noise, final_act, skip=None, w_pre=None,
      b_pre=None):
    return x.new_empty((*x.shape[:3], w_pw.shape[-1]))


def fused_block(x: torch.Tensor, w_dw: torch.Tensor, b_dw: torch.Tensor,
                w_pw: torch.Tensor, noise: Optional[torch.Tensor] = None,
                final_act: bool = True, skip: Optional[torch.Tensor] = None,
                w_pre: Optional[torch.Tensor] = None,
                b_pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused (+skip) -> (act(pw_pre + b_pre)) -> dw3x3 + b -> act -> pw1x1
    (+noise) (-> act).

    x: [N, H, W, Cin] contiguous; skip: optional [N, H, W, Cin], added to
    x first; w_pre: optional [Cin, C] and b_pre [C], the pointwise
    prologue (both or neither; without it Cin = C); w_dw: [3, 3, C];
    b_dw: [C]; w_pw: [C, O]; noise: optional [H, W] per-pixel scalar
    (already scaled by its strength), broadcast over batch and channels.
    All of one dtype; C and O multiples of 8 on CUDA, and Cin too, or 4
    with the prologue. Returns [N, H, W, O]. CPU tensors take the plain
    version; any device but CPU and CUDA raises.

    The prologue runs on the CUDA cores. It pays off at a small Cin: at
    Cin = 4 one call took 0.41-0.60x fromrgb (1x1 conv + act) then this
    kernel; at Cin = 128 it took 2.2x its plain version (NVIDIA H100
    80GB HBM3, 700 W; `chip_smoke.py` phase 11). Fuse it only where Cin
    is small.
    """
    return launch.call(KERNEL, fused_block_op, sepconv_plain,
                       (x, w_dw, b_dw, w_pw, noise, final_act, skip, w_pre,
                        b_pre))
