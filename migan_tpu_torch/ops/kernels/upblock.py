"""Fused up-sampling synthesis block:
``t = act(up2_[1,3,3,1](x_lo) + noise_up) + skip``;
``y = act(pw1x1(act(dw3x3(t) + b_dw)) [+ noise2])``;
optional torgb epilogue ``rgb = y . w_rgb + b_rgb``, to which the rgb
pyramid's ``up2_[1,3,3,1](img_lo)`` is added when an image of the level
below is given.

Port of `migan_tpu/ops/pallas/upblock.py::fused_up_block` as one CUDA
kernel (`csrc/upblock.cu`: t once per hi-res pixel of a tile, pointwise
product on tensor cores, torgb summed in a fixed order) on contiguous NHWC
tensors. Its launch geometry comes from `plan.launch_plan`. With
`phase_input=True` x_lo is `[N, Hl, Wl, 4C]`, the four up-sampling
phases that `ops/conv.py::pw_up2_phase` computes with the FIR folded
into the preceding pointwise conv, and the up-sample is a pure
depth-to-space interleave (`_xla_up_block_phase` in JAX). With `img_lo`
[N, Hl, Wl, 3], the generator's rgb of the level below, the epilogue
adds its up-sample by the same FIR (`ops/upfirdn2d.py::upsample2d`'s
padding, zero borders) to rgb in float32 before rgb's one store; each
launch given it adds one to the counter `kernels.upblock.rgb_folds`.

The `torch.library` custom op `migan::fused_up_block` is the ctypes
launch on CUDA (`launch.launch` of `KERNEL`), `upblock_plain`'s
arithmetic on the CPU and a fake implementation for `torch.export`. The
wrapper calls it while something traces or records the call, and the
launch or the plain version directly otherwise (`launch.call`). A
custom op has a fixed output schema, so the op always returns the pair
(features, rgb), with an empty [0] tensor, allocated and never written,
in place of an output not asked for; a direct launch allocates no such
tensor. The wrapper returns what its arguments ask for on either path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..conv import conv2d
from ..filters import setup_filter
from ..upfirdn2d import upsample2d
from . import launch, plan
from .downblock import FIR_TAPS
from .sepconv import ACT

OP = "migan::fused_up_block"


def _outputs(feat, rgb, emit_features):
    if rgb is None:
        return feat
    return (feat, rgb) if emit_features else rgb


def check_phase(name: str, x_lo: torch.Tensor, phase_input: bool) -> None:
    """Raise when a phase input's channels are not four groups."""
    if phase_input and x_lo.shape[-1] % 4:
        raise ValueError(f"{name}: phase_input x_lo has {x_lo.shape[-1]} "
                         f"channels, not a multiple of 4")


def check_img_lo(name: str, x_lo: torch.Tensor, w_rgb, img_lo) -> None:
    """Raise when an image of the level below comes without torgb, or is
    not [N, Hl, Wl, 3] at x_lo's batch and size."""
    if img_lo is None:
        return
    if w_rgb is None:
        raise ValueError(f"{name}: img_lo needs w_rgb and b_rgb")
    if img_lo.shape != (*x_lo.shape[:3], 3):
        raise ValueError(f"{name}: img_lo {tuple(img_lo.shape)}, expected "
                         f"{(*x_lo.shape[:3], 3)}")


def _up2(x):
    """x up-sampled by the [1,3,3,1] FIR."""
    return upsample2d(x, setup_filter(FIR_TAPS, device=x.device), up=2)


def _hires(x_lo, phase_input):
    """x_lo at the hi-res grid: the [1,3,3,1] up-2 FIR, or with
    phase_input the four phase groups interleaved (depth-to-space)."""
    if not phase_input:
        return _up2(x_lo)
    n, hl, wl, xc = x_lo.shape
    c = xc // 4
    return (x_lo.reshape(n, hl, wl, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, 2 * hl, 2 * wl, c))


def _plain(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2, w_rgb, b_rgb,
           emit_features=True, phase_input=False, img_lo=None):
    """(features, rgb or None) in plain PyTorch, on the op's arguments:
    emit_features is the caller's to apply."""
    check_phase("upblock_plain", x_lo, phase_input)
    check_img_lo("upblock_plain", x_lo, w_rgb, img_lo)
    t = _hires(x_lo, phase_input)
    t = ACT(t + noise_up[None, :, :, None]) + skip
    c = t.shape[-1]
    y = ACT(conv2d(t, w_dw[:, :, None, :], padding=1, groups=c) + b_dw)
    y = conv2d(y, w_pw[None, None])
    if noise2 is not None:
        y = y + noise2[None, :, :, None]
    y = ACT(y)
    rgb = None if w_rgb is None else conv2d(y, w_rgb[None, None]) + b_rgb
    if img_lo is not None:
        rgb = _up2(img_lo) + rgb
    return y, rgb


def upblock_plain(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2=None,
                  w_rgb=None, b_rgb=None, emit_features=True,
                  phase_input=False, img_lo=None):
    """The same outputs as :func:`fused_up_block`, in plain PyTorch."""
    return _outputs(*_plain(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2,
                            w_rgb, b_rgb, phase_input=phase_input,
                            img_lo=img_lo),
                    emit_features)


def _check(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2, w_rgb, b_rgb,
           emit_features, phase_input, img_lo=None) -> None:
    """Every check of a launch: raise on what the kernel does not take."""
    check_phase("fused_up_block", x_lo, phase_input)
    check_img_lo("fused_up_block", x_lo, w_rgb, img_lo)
    n, hl, wl, c = x_lo.shape
    if phase_input:
        c //= 4
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
    launch.check_cuda_args("fused_up_block", x_lo.dtype, x_lo.device,
                           x_lo=x_lo, skip=skip, noise_up=noise_up,
                           w_dw=w_dw, b_dw=b_dw, w_pw=w_pw, noise2=noise2,
                           w_rgb=w_rgb, b_rgb=b_rgb, img_lo=img_lo)
    plan.check_tc_args("fused_up_block", x_lo, w_pw)
    plan.check_tc_args("fused_up_block", skip, w_pw)


def _layout(key):
    """(plan, mode, sizes, outputs) of a key whose checks passed. The
    outputs: features if emit_features, rgb with w_rgb, and with w_rgb
    over more than one output tile the tiles' float32 rgb partial sums,
    which a second launch adds in tile order."""
    (n, hl, wl, c), _, hw, _, _, (_, o), _, w_rgb, _, emit_features, \
        phase_input, _, dtype, _ = key
    if phase_input:
        c //= 4
    mode = plan.UP_PHASE if phase_input else plan.UP_PLAIN
    p = plan.launch_plan("upblock", n, hl, wl, o, dtype, mode=mode)
    feat = ((n, *hw, o), None) if emit_features else None
    rgb = None if w_rgb is None else ((n, *hw, 3), None)
    part = ((p.out_tiles, n, *hw, 3), torch.float32) \
        if rgb and p.out_tiles > 1 else None
    return p, (mode,), (n, hl, wl, c, o), (feat, rgb, part)


# the entry point's pointers: the nine tensor arguments in order and
# img_lo, then features, rgb and the partial sums; a launch returns
# (features or None, rgb or None), and one given img_lo is counted in
# `kernels.upblock.rgb_folds`
_TENSORS = (*range(9), 11)
KERNEL = launch.Kernel("upblock", "fused_up_block", _check, _layout,
                       tensors=_TENSORS, ins=_TENSORS, aligned=(0, 1, 5),
                       returns=slice(2), fold=11)


def _pair(x_lo, feat, rgb):
    """The op's fixed (features, rgb) pair: [0] for a missing output."""
    return (x_lo.new_empty((0,)) if feat is None else feat,
            x_lo.new_empty((0,)) if rgb is None else rgb)


@torch.library.custom_op(OP, mutates_args=(), device_types="cuda")
def fused_up_block_op(x_lo: torch.Tensor, skip: torch.Tensor,
                      noise_up: torch.Tensor, w_dw: torch.Tensor,
                      b_dw: torch.Tensor, w_pw: torch.Tensor,
                      noise2: Optional[torch.Tensor],
                      w_rgb: Optional[torch.Tensor],
                      b_rgb: Optional[torch.Tensor], emit_features: bool,
                      phase_input: bool = False,
                      img_lo: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _pair(x_lo, *launch.launch(KERNEL, (
        x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2, w_rgb, b_rgb,
        emit_features, phase_input, img_lo)))


@fused_up_block_op.register_kernel("cpu")
def _(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2, w_rgb, b_rgb,
      emit_features, phase_input=False, img_lo=None):
    feat, rgb = _plain(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2,
                       w_rgb, b_rgb, phase_input=phase_input, img_lo=img_lo)
    return _pair(x_lo, feat if emit_features else None, rgb)


@fused_up_block_op.register_fake
def _(x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2, w_rgb, b_rgb,
      emit_features, phase_input=False, img_lo=None):
    n, hl, wl, _ = x_lo.shape
    hw = (2 * hl, 2 * wl)
    return _pair(x_lo,
                 x_lo.new_empty((n, *hw, w_pw.shape[-1]))
                 if emit_features else None,
                 x_lo.new_empty((n, *hw, 3)) if w_rgb is not None else None)


def fused_up_block(x_lo: torch.Tensor, skip: torch.Tensor,
                   noise_up: torch.Tensor, w_dw: torch.Tensor,
                   b_dw: torch.Tensor, w_pw: torch.Tensor,
                   noise2: Optional[torch.Tensor] = None,
                   w_rgb: Optional[torch.Tensor] = None,
                   b_rgb: Optional[torch.Tensor] = None,
                   emit_features: bool = True, phase_input: bool = False,
                   img_lo: Optional[torch.Tensor] = None):
    """Fused up2 + noise + act + skip + dw3x3/pw1x1 (+noise2) + act
    (+ torgb (+ the up-sampled image of the level below)).

    x_lo: [N, Hl, Wl, C], or with phase_input [N, Hl, Wl, 4C], whose
    channel group (ph * 2 + pw) * C + c is hi-res pixel (2i + ph,
    2j + pw) (`ops/conv.py::pw_up2_phase`); skip: [N, 2Hl, 2Wl, C];
    noise_up, noise2:
    [2Hl, 2Wl] pre-scaled noise; w_dw: [3, 3, C]; b_dw: [C]; w_pw: [C, O];
    w_rgb: [O, 3] and b_rgb: [3] for the torgb epilogue; img_lo:
    [N, Hl, Wl, 3], with w_rgb, makes rgb ``upsample2d(img_lo, [1,3,3,1])
    + rgb``, the up-sample in float32 until rgb is stored. All contiguous
    and of one dtype; C and O multiples of 8 on CUDA.

    Returns the features [N, 2Hl, 2Wl, O]; with w_rgb the tuple
    (features, rgb [N, 2Hl, 2Wl, 3]), or only rgb when emit_features is
    False (the top level, where nothing else reads the features). CPU
    tensors take the plain version.
    """
    if (w_rgb is None) != (b_rgb is None):
        raise ValueError("fused_up_block: pass both w_rgb and b_rgb")
    if w_rgb is None and not emit_features:
        raise ValueError("fused_up_block: no output requested")
    feat, rgb = launch.call(KERNEL, fused_up_block_op, _plain, (
        x_lo, skip, noise_up, w_dw, b_dw, w_pw, noise2, w_rgb, b_rgb,
        emit_features, phase_input, img_lo))
    return _outputs(feat, None if w_rgb is None else rgb, emit_features)
