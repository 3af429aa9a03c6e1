"""The MI-GAN deploy generator in plain PyTorch, float32, NCHW.

Written from the published model (Picsart-AI-Research/MI-GAN,
`lib/model_zoo/migan_inference.py`): an encoder of separable-conv blocks
that halves the resolution down to 4x4, a synthesis path back up with a
skip from each encoder level, per-level noise, and an RGB output summed
over the levels. Resampling is the [1,3,3,1] FIR (`upfirdn2d`), the
activation leaky ReLU 0.2 with gain sqrt(2) and clamp 256.

`param_shapes` lists the checkpoint's learnable tensors under the names
of the published `state_dict` (the fixed FIR buffers left out), and
`seeded_state` draws them from a seed on any device in three calls.
`forward` takes that state and an NHWC input and returns NHWC RGB, like
the program's entry point. With `tf32=True` its convolutions may run in
TF32: that is the control of lower precision, not the reference.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

_FIR = torch.tensor([1.0, 3.0, 3.0, 1.0], dtype=torch.float64)
FIR_2D = (torch.outer(_FIR, _FIR) / torch.outer(_FIR, _FIR).sum()).float()
# The configuration's keys that set the network's shape.
SHAPE_KEYS = ("resolution", "ch_base", "ch_max", "ic_n", "rgb_n")


def channels(cfg: dict, res: int) -> int:
    return min(cfg["ch_base"] // res, cfg["ch_max"])


def levels(cfg: dict) -> List[int]:
    """[resolution, resolution / 2, ..., 4]."""
    r = cfg["resolution"]
    if r < 8 or r & (r - 1):
        raise ValueError(f"resolution {r} is not a power of 2 >= 8")
    out = []
    while r >= 4:
        out.append(r)
        r //= 2
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every tensor of the checkpoint (OIHW conv
    weights), in the published module order."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(prefix, o, i, k, bias=True):
        shapes[f"{prefix}.weight"] = (o, i, k, k)
        if bias:
            shapes[f"{prefix}.bias"] = (o,)

    def sep(prefix, ci, co, noise_res=None):
        if noise_res is not None:
            shapes[f"{prefix}.noise_strength"] = ()
            shapes[f"{prefix}.noise_const"] = (noise_res, noise_res)
        conv(f"{prefix}.conv1", ci, 1, 3)
        conv(f"{prefix}.conv2", co, ci, 1, bias=False)

    lv = levels(cfg)
    for idx, (ri, rj) in enumerate(zip(lv[:-1], lv[1:])):
        ci, cj = channels(cfg, ri), channels(cfg, rj)
        if idx == 0:
            conv(f"encoder.b{ri}.fromrgb", ci, cfg["ic_n"], 1)
        sep(f"encoder.b{ri}.conv1", ci, ci)
        sep(f"encoder.b{ri}.conv2", ci, cj)
    c4 = channels(cfg, 4)
    sep("encoder.b4.conv1", c4, c4)
    sep("encoder.b4.conv2", c4, c4)
    sep("synthesis.b4.conv1", c4, c4)
    sep("synthesis.b4.conv2", c4, c4)
    conv("synthesis.b4.torgb", cfg["rgb_n"], c4, 1)
    up = lv[::-1]
    for ri, rj in zip(up[:-1], up[1:]):
        ci, cj = channels(cfg, ri), channels(cfg, rj)
        sep(f"synthesis.b{rj}.conv1", ci, cj, noise_res=rj)
        sep(f"synthesis.b{rj}.conv2", cj, cj, noise_res=rj)
        conv(f"synthesis.b{rj}.torgb", cfg["rgb_n"], cj, 1)
    return shapes


def count_params(cfg: dict) -> int:
    """Learnable parameters (noise_const is a buffer, as published)."""
    return sum(math.prod(s) for k, s in param_shapes(cfg).items()
               if not k.endswith("noise_const"))


@torch.no_grad()
def seeded_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The checkpoint drawn from `seed` on `device`, float32, in three
    calls of one generator: weights and biases U(-1, 1) scaled by
    1 / sqrt(fan_in) (torch's conv init), noise planes N(0, 1), noise
    strengths N(0, 0.25) (non-zero, as trained ones are)."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    f32 = dict(dtype=torch.float32, device=device)
    kind = {k: ("noise" if k.endswith("noise_const") else
                "strength" if k.endswith("noise_strength") else "conv")
            for k in shapes}
    total = {t: sum(math.prod(s) for k, s in shapes.items() if kind[k] == t)
             for t in ("conv", "noise", "strength")}
    pools = {"conv": torch.rand(total["conv"], generator=gen, **f32)
             .mul_(2).sub_(1),
             "noise": torch.randn(total["noise"], generator=gen, **f32),
             "strength": torch.randn(total["strength"], generator=gen,
                                     **f32).mul_(0.5)}
    offs = dict.fromkeys(pools, 0)
    state = {}
    for k, s in shapes.items():
        t, n = kind[k], math.prod(s)
        v = pools[t][offs[t]:offs[t] + n].view(s)
        offs[t] += n
        if t == "conv":
            weight = shapes[k[:-len(".bias")] + ".weight"] \
                if k.endswith(".bias") else s
            v = v * (1.0 / math.sqrt(math.prod(weight[1:])))
        state[k] = v.clone()
    return state


def act(x: torch.Tensor) -> torch.Tensor:
    """lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)."""
    return (torch.where(x >= 0, x, x * 0.2) * math.sqrt(2.0)).clamp(-256,
                                                                      256)


def _fir(x: torch.Tensor, pad: Tuple[int, int], stride: int) -> torch.Tensor:
    c = x.shape[1]
    f = FIR_2D.to(x.device, x.dtype)[None, None].expand(c, 1, 4, 4)
    x = F.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    return F.conv2d(x, f, stride=stride, groups=c)


def down2(x: torch.Tensor) -> torch.Tensor:
    """upfirdn2d(x, f, down=2): pad 1 / 1, filter, keep every second."""
    return _fir(x, (1, 1), 2)


def up2(x: torch.Tensor) -> torch.Tensor:
    """upfirdn2d(x, f, up=2, gain=4): zero-insert, pad 2 / 1, filter."""
    n, c, h, w = x.shape
    z = x.new_zeros(n, c, 2 * h, 2 * w)
    z[:, :, ::2, ::2] = x
    return _fir(z, (2, 1), 1) * 4.0


def _sep(s, p: str, x: torch.Tensor, down=False, up=False,
         noise=False) -> torch.Tensor:
    """SeparableConv2d: dw 3x3 + b -> act -> [down] -> pw 1x1 -> [up]
    -> [+ noise] -> act."""
    x = F.conv2d(x, s[f"{p}.conv1.weight"], s[f"{p}.conv1.bias"], padding=1,
                 groups=x.shape[1])
    x = act(x)
    if down:
        x = down2(x)
    x = F.conv2d(x, s[f"{p}.conv2.weight"])
    if up:
        x = up2(x)
    if noise:
        nc = s[f"{p}.noise_const"]
        if nc.shape != x.shape[2:]:
            raise ValueError(f"{p}: noise {tuple(nc.shape)} at "
                             f"{tuple(x.shape[2:])}: only the model's size")
        x = x + (nc * s[f"{p}.noise_strength"])[None, None]
    return act(x)


def _rgb(s, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, s[f"{p}.torgb.weight"], s[f"{p}.torgb.bias"])


@contextmanager
def precision(tf32: bool):
    """IEEE float32 convolutions and products (or TF32 for the control),
    restored on exit."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


@torch.no_grad()
def forward(cfg: dict, state: Dict[str, torch.Tensor], x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """x [N, R, R, 4] = concat(mask - 0.5, rgb * mask), rgb in [-1, 1],
    mask 1 = known -> [N, R, R, 3], all float32 on the state's device."""
    s = state
    lv = levels(cfg)
    with precision(tf32):
        img = x.permute(0, 3, 1, 2).float()
        feats = {}
        h = None
        for idx, r in enumerate(lv[:-1]):
            p = f"encoder.b{r}"
            if idx == 0:
                h = act(F.conv2d(img, s[f"{p}.fromrgb.weight"],
                                 s[f"{p}.fromrgb.bias"]))
            feats[r] = _sep(s, f"{p}.conv1", h)
            h = _sep(s, f"{p}.conv2", feats[r], down=True)
        feats[4] = _sep(s, "encoder.b4.conv1", h)
        h = _sep(s, "encoder.b4.conv2", feats[4])
        h = _sep(s, "synthesis.b4.conv1", h)
        h = _sep(s, "synthesis.b4.conv2", h + feats[4])
        rgb = _rgb(s, "synthesis.b4", h)
        for r in lv[-2::-1]:
            p = f"synthesis.b{r}"
            h = _sep(s, f"{p}.conv1", h, up=True, noise=True)
            h = _sep(s, f"{p}.conv2", h + feats[r], noise=True)
            rgb = up2(rgb) + _rgb(s, p, h)
        return rgb.permute(0, 2, 3, 1).contiguous()
