"""Convolutions, NHWC x HWIO -> NHWC (port of `migan_tpu/ops/conv.py`;
reference torch_utils/ops/conv2d_resample.py:59-154), through `F.conv2d`
on the NCHW view of the same memory.

`conv2d` is the plain grouped conv, the plain path that the fused kernels
replace (a depthwise one through `ops/depthwise.py`, whose backward the
training nets can differentiate again); `conv2d_resample` is the one conv
primitive of the training nets, a conv with FIR up- or down-sampling in
the JAX package's four orderings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .depthwise import depthwise_conv2d
from .filters import filter_size, parse_padding
from .upfirdn2d import upfirdn2d


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
           groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """x [N, H, W, Cin], w [kh, kw, Cin // groups, O] -> contiguous
    [N, H', W', O].

    padding: int, (py, px), or ((py0, py1), (px0, px1)); negative crops.
    flip_weight=True correlates, as torch and lax compute it; False is a
    true convolution (the weights flipped in space).
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
    if not flip_weight:
        w = w.flip([2, 3])
    symmetric = py0 == py1 and px0 == px1 and py0 >= 0 and px0 >= 0
    if groups > 1 and groups == x.shape[-1] == w.shape[0]:
        # depthwise: its own backward (ops/depthwise.py)
        if not symmetric:
            y, py0, px0 = F.pad(y, [px0, px1, py0, py1]), 0, 0
        y = depthwise_conv2d(y, w, stride, (py0, px0))
    elif symmetric:
        y = F.conv2d(y, w, stride=stride, padding=(py0, px0), groups=groups)
    else:
        y = F.conv2d(F.pad(y, [px0, px1, py0, py1]), w, stride=stride,
                     groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_resample(x: torch.Tensor, w: torch.Tensor,
                    f: torch.Tensor | None = None, up: int = 1,
                    down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True,
                    flip_filter: bool = False) -> torch.Tensor:
    """Conv with optional FIR-filtered up/down-sampling; x NHWC, w HWIO,
    f a prepared filter (`filters.setup_filter`). padding is with respect
    to the up-sampled image. As in the JAX package:

      - 1x1 kernel and up > 1: the conv at low resolution, then the FIR
        up-sampling;
      - down > 1: the FIR at full resolution, then a strided conv;
      - neither: one conv with the (possibly asymmetric) padding;
      - any other up: zero-insert + FIR, the conv, then FIR-down if asked.
    """
    if not (isinstance(up, int) and up >= 1 and isinstance(down, int)
            and down >= 1):
        raise ValueError(f"conv2d_resample: up {up!r} down {down!r}")
    kh, kw = int(w.shape[0]), int(w.shape[1])
    fw, fh = filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1],
                         gain=up ** 2, flip_filter=flip_filter)
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return conv2d(x, w, stride=down, groups=groups,
                      flip_weight=flip_weight)
    if up == 1 and down == 1:
        return conv2d(x, w, padding=((py0, py1), (px0, px1)), groups=groups,
                      flip_weight=flip_weight)
    x = upfirdn2d(x, f if up > 1 else None, up=up,
                  padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    x = conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x


# Per-axis taps of the [1,3,3,1] up-2 FIR (gain 4) folded into a 1x1
# conv: output row 2j (even phase) reads low-res rows j - 1, j; row 2j + 1
# (odd) rows j, j + 1. Each with its (before, after) zero padding.
_PHASE_TAPS = (((0.25, 0.75), (1, 0)), ((0.75, 0.25), (0, 1)))


def pw_up2_phase(x: torch.Tensor, w_pw: torch.Tensor,
                 packed: bool = False) -> torch.Tensor:
    """Pointwise conv with the up-2 FIR folded in (port of
    `migan_tpu/ops/conv.py::pw_up2_phase`): x [N, H, W, Ci] and w_pw
    [Ci, Co] (or [1, 1, Ci, Co]) -> [N, H, W, 4 Co], whose channel group
    (ph * 2 + pw) * Co + c holds up-sampling phase (ph, pw), the layout
    `fused_up_block(phase_input=True)` reads. Equal to the 1x1 conv
    followed by `upsample2d` with the [1,3,3,1] filter, as four
    phase-weighted 2x2 convs (4x the 1x1 conv's products), or with
    packed=True one 3x3 conv with 4 Co outputs (9x)."""
    if w_pw.ndim == 4:
        w_pw = w_pw[0, 0]
    ci, co = w_pw.shape
    w = w_pw.to(x.dtype)

    def phase_kernel(fy, fx):
        f = torch.tensor(fy, dtype=x.dtype, device=x.device)[:, None] * \
            torch.tensor(fx, dtype=x.dtype, device=x.device)[None, :]
        return f[:, :, None, None] * w                   # [kh, kw, Ci, Co]

    if packed:
        wide = {0: (0.25, 0.75, 0.0), 1: (0.0, 0.75, 0.25)}
        k = torch.cat([phase_kernel(wide[ph], wide[pw])
                       for ph in (0, 1) for pw in (0, 1)], dim=-1)
        return conv2d(x, k, padding=1)
    return torch.cat([conv2d(x, phase_kernel(fy, fx), padding=(py, px))
                      for fy, py in _PHASE_TAPS for fx, px in _PHASE_TAPS],
                     dim=-1)
