"""Depthwise convolution (groups = channels, one filter per channel) whose
backward is made of elementwise products, pads and sums.

`F.conv2d(..., groups=C)` differentiates through ATen's grouped
convolution backward, and that is what the training nets cannot afford:
its double backward (R1 differentiates D's input gradient) runs one
convolution per channel, thousands a step, and under deterministic
algorithms cuDNN's grouped input gradient takes a slow algorithm (PERF.md
section 6). Here the forward is the same grouped `F.conv2d`, and
the backward is written with forward convolutions, pads and sums, which
autograd differentiates again as first-order ops. Without autograd
(inference, `torch.export`) it is `F.conv2d`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     stride: Tuple[int, int] = (1, 1),
                     padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x [N, C, H, W], w [C, 1, kh, kw], zero padding (py, px) on both
    sides -> [N, C, (H + 2 py - kh) // sy + 1, (W + 2 px - kw) // sx + 1]."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Depthwise.apply(x, w, stride, padding)
    return F.conv2d(x, w, stride=stride, padding=padding, groups=x.shape[1])


class _Depthwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return F.conv2d(x, w, stride=stride, padding=padding,
                        groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = _grads(x, w, g, ctx.stride, ctx.padding,
                        ctx.needs_input_grad[:2])
        return gx, gw, None, None


def _grads(x, w, g, stride, padding, needs):
    """(dL/dx, dL/dw) of y = depthwise(x, w) for dL/dy = g: output pixel
    (a, b) reads xp[a sy + i, b sx + j] w[i, j] of the padded input xp.

    dL/dx is a grouped forward convolution of g, zero-inserted onto the
    input's grid, with the flipped filter (deterministic and fast where
    cuDNN's grouped input gradient is not). dL/dw is cuDNN's weight
    gradient, or, when the backward itself is being differentiated
    (`create_graph`), elementwise products and sums."""
    py, px = padding
    n, c = x.shape[:2]
    h, wd = x.shape[2] + 2 * py, x.shape[3] + 2 * px
    kh, kw = w.shape[2:]
    sy, sx = stride
    ho, wo = g.shape[2:]
    gx = gw = None
    if needs[0]:
        gd = g
        if sy > 1 or sx > 1:      # g zero-inserted onto the input's grid
            gd = F.pad(g.reshape(n, c, ho, 1, wo, 1),
                       [0, sx - 1, 0, 0, 0, sy - 1])
            gd = gd.reshape(n, c, ho * sy, wo * sx)
            gd = gd[:, :, :(ho - 1) * sy + 1, :(wo - 1) * sx + 1]
        gx = F.conv2d(gd, w.flip([2, 3]), padding=(kh - 1, kw - 1),
                      groups=c)
        # rows and columns of xp that no output reads get no gradient
        gx = F.pad(gx, [0, wd - gx.shape[3], 0, h - gx.shape[2]])
        gx = gx[:, :, py:h - py, px:wd - px]
    if needs[1] and torch.is_grad_enabled():
        xp = F.pad(x, [px, px, py, py]) if py or px else x
        taps = [(g * xp[:, :, i:i + (ho - 1) * sy + 1:sy,
                        j:j + (wo - 1) * sx + 1:sx]).sum(dim=(0, 2, 3))
                for i in range(kh) for j in range(kw)]
        gw = torch.stack(taps, dim=1).reshape(c, 1, kh, kw)
    elif needs[1]:
        gw = torch.ops.aten.convolution_backward(
            g, x, w, None, stride, padding, (1, 1), False, (0, 0), c,
            (False, True, False))[1]
    return gx, gw
