"""MI-GAN deployment generator in PyTorch, NHWC at the boundary.

Port of `migan_tpu/models/migan_inference.py` (reference
lib/model_zoo/migan_inference.py:106-369): an encoder/decoder of
SeparableConv2d blocks with [1,3,3,1] FIR resampling, the lrelu_agc
activation, per-resolution skips and an accumulated RGB output. Resampling
is computed (`ops.upfirdn2d`) and `noise_const` is cropped or tiled to the
runtime size, so the net is fully convolutional.

The weights are a `Generator` module whose parameter paths read like the
JAX pytree (`encoder.b512.conv1.conv1.weight`); `generator_apply` is the
plain forward, the port's oracle for the kernel chain
(`models/migan_kernels.py`).

Input:  x [N, H, W, 4] = concat([mask - 0.5, rgb * mask]), rgb in [-1, 1].
Output: [N, H, W, 3] RGB.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..ops import conv2d, downsample2d, lrelu_agc, setup_filter, upsample2d

# The model's single activation (reference migan_inference.py:179).
ACT = lrelu_agc(alpha=0.2, gain="sqrt_2", clamp=256)
_FILTER_TAPS = (1, 3, 3, 1)


def resample_filter(device=None) -> torch.Tensor:
    return setup_filter(list(_FILTER_TAPS), device=device)


@dataclass(frozen=True)
class GeneratorConfig:
    """Static architecture config (depth and channel schedule)."""

    resolution: int = 256
    ic_n: int = 4
    rgb_n: int = 3
    ch_base: int = 32768
    ch_max: int = 512

    @property
    def log2res(self) -> int:
        l = int(math.log2(self.resolution))
        if 2 ** l != self.resolution:
            raise ValueError(f"resolution {self.resolution} not a power of 2")
        return l

    @property
    def encode_res(self):
        """[res, res/2, ..., 4] (reference migan_inference.py:217)."""
        return [2 ** i for i in range(self.log2res, 1, -1)]

    @property
    def block_res(self):
        """[4, 8, ..., res] (reference migan_inference.py:332)."""
        return [2 ** i for i in range(2, self.log2res + 1)]

    def ch(self, res: int) -> int:
        return min(self.ch_base // res, self.ch_max)


# ---------------------------------------------------------------------------
# Modules: parameter holders only; the forward is the functions below.
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    """A conv's weight [O, I/groups, k, k] (torch layout) and bias [O]."""

    def __init__(self, out_ch: int, in_ch: int, k: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def hwio(self) -> torch.Tensor:
        """The weight as HWIO, the layout of `ops.conv2d` (a view)."""
        return self.weight.permute(2, 3, 1, 0)


class SeparableConv(nn.Module):
    """Depthwise 3x3 `conv1` (+bias), pointwise 1x1 `conv2` (no bias),
    and for synthesis layers a `noise_const` buffer [res, res] scaled by
    the learned scalar `noise_strength`."""

    def __init__(self, ic: int, oc: int, noise_res: Optional[int] = None):
        super().__init__()
        self.conv1 = Conv(ic, 1, 3)
        self.conv2 = Conv(oc, ic, 1, bias=False)
        self.use_noise = noise_res is not None
        if self.use_noise:
            self.register_buffer("noise_const",
                                 torch.empty(noise_res, noise_res))
            self.noise_strength = nn.Parameter(torch.zeros(()))


class EncoderBlock(nn.Module):
    def __init__(self, ci: int, cj: int, ic_n: Optional[int] = None):
        super().__init__()
        self.fromrgb = Conv(ci, ic_n, 1) if ic_n is not None else None
        self.conv1 = SeparableConv(ci, ci)
        self.conv2 = SeparableConv(ci, cj)


class SynthesisBlock(nn.Module):
    def __init__(self, ci: int, cj: int, rgb_n: int,
                 noise_res: Optional[int] = None):
        super().__init__()
        self.conv1 = SeparableConv(ci, cj, noise_res)
        self.conv2 = SeparableConv(cj, cj, noise_res)
        self.torgb = Conv(rgb_n, cj, 1)


class Generator(nn.Module):
    """`encoder.b{res}` for res = resolution..4 and `synthesis.b{res}` for
    res = 4..resolution, as in the JAX pytree."""

    def __init__(self, cfg: GeneratorConfig = GeneratorConfig()):
        super().__init__()
        self.cfg = cfg
        enc = {}
        res_list = cfg.encode_res
        for idx, (ri, rj) in enumerate(zip(res_list[:-1], res_list[1:])):
            enc[f"b{ri}"] = EncoderBlock(cfg.ch(ri), cfg.ch(rj),
                                         cfg.ic_n if idx == 0 else None)
        c4 = cfg.ch(4)
        enc["b4"] = EncoderBlock(c4, c4)
        self.encoder = nn.ModuleDict(enc)
        syn = {"b4": SynthesisBlock(c4, c4, cfg.rgb_n)}
        res_list = cfg.block_res
        for ri, rj in zip(res_list[:-1], res_list[1:]):
            syn[f"b{rj}"] = SynthesisBlock(cfg.ch(ri), cfg.ch(rj), cfg.rgb_n,
                                           noise_res=rj)
        self.synthesis = nn.ModuleDict(syn)


# ---------------------------------------------------------------------------
# Initialization: torch nn.Conv2d statistics, as in the JAX package —
# kaiming_uniform(a=sqrt 5) weights, bias ~ U(±1/sqrt(fan_in)),
# noise_const ~ N(0, 1), noise_strength = 0.
# ---------------------------------------------------------------------------

@torch.no_grad()
def generator_init(cfg: GeneratorConfig,
                   generator: torch.Generator) -> Generator:
    """A `Generator` with random weights drawn from `generator` (on the
    CPU; move it with `.to(device)`)."""
    g = Generator(cfg)
    for m in g.modules():
        if isinstance(m, Conv):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)   # sqrt(6 / ((1 + 5) fan_in))
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, SeparableConv) and m.use_noise:
            m.noise_const.normal_(generator=generator)
            m.noise_strength.zero_()
    return g


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _noise_for(p: SeparableConv, h: int, w: int) -> torch.Tensor:
    """noise_const at the runtime size [h, w], scaled by its strength:
    the trained buffer verbatim at the trained size, a top-left crop when
    smaller, tiled when larger."""
    nc = p.noise_const
    nh, nw = nc.shape
    if (h, w) != (nh, nw):
        reps = (max(1, -(-h // nh)), max(1, -(-w // nw)))
        nc = nc.tile(reps)[:h, :w]
    return nc * p.noise_strength


class Stencils:
    """The forward's ops that read neighbouring rows (the depthwise 3x3 and
    the [1,3,3,1] FIR resampling) and its noise at a tensor's size. These
    are the one-process forward's, zero padding at the image's edges;
    `parallel/spatial.py` replaces them to run on a block of the image's
    rows, and every other op of the forward is local to a row."""

    def dw3x3(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return conv2d(x, w, padding=1, groups=x.shape[-1])

    def down(self, x: torch.Tensor, f: torch.Tensor,
             down: int = 2) -> torch.Tensor:
        return downsample2d(x, f, down=down)

    def up(self, x: torch.Tensor, f: torch.Tensor,
           up: int = 2) -> torch.Tensor:
        return upsample2d(x, f, up=up)

    def noise(self, p: SeparableConv, h: int, w: int) -> torch.Tensor:
        return _noise_for(p, h, w)


PLAIN = Stencils()


def sep_conv_apply(p: SeparableConv, x: torch.Tensor, f: torch.Tensor, *,
                   down: int = 1, up: int = 1, use_noise: bool = False,
                   stencils: Stencils = PLAIN) -> torch.Tensor:
    """SeparableConv2d (reference migan_inference.py:106-170): depthwise
    3x3 (+bias) -> act -> [down] -> pointwise 1x1 -> [up] -> [+noise]
    -> act."""
    x = stencils.dw3x3(x, p.conv1.hwio())
    x = ACT(x + p.conv1.bias)
    if down > 1:
        x = stencils.down(x, f, down=down)
    x = conv2d(x, p.conv2.hwio())
    if up > 1:
        x = stencils.up(x, f, up=up)
    if use_noise:
        n = stencils.noise(p, x.shape[1], x.shape[2])
        x = x + n[None, :, :, None].to(x.dtype)
    return ACT(x)


def conv1x1_apply(p: Conv, x: torch.Tensor) -> torch.Tensor:
    x = conv2d(x, p.hwio())
    return x + p.bias if p.bias is not None else x


def encoder_block_apply(p: EncoderBlock, x: Optional[torch.Tensor],
                        img: Optional[torch.Tensor], f, *, down: int,
                        stencils: Stencils = PLAIN):
    """Reference migan_inference.py:173-200. Returns (x, skip feature)."""
    if p.fromrgb is not None:
        y = ACT(conv1x1_apply(p.fromrgb, img))
        x = x + y if x is not None else y
    feat = sep_conv_apply(p.conv1, x, f, stencils=stencils)
    x = sep_conv_apply(p.conv2, feat, f, down=down, stencils=stencils)
    return x, feat


def encoder_apply(enc: nn.ModuleDict, cfg: GeneratorConfig,
                  img: torch.Tensor, f, stencils: Stencils = PLAIN):
    """Reference migan_inference.py:235-246: the bottleneck and the skip
    features keyed by block level."""
    x = None
    feats: Dict[int, torch.Tensor] = {}
    for resi in cfg.encode_res[:-1]:
        x, feats[resi] = encoder_block_apply(enc[f"b{resi}"], x, img, f,
                                             down=2, stencils=stencils)
    x, feats[4] = encoder_block_apply(enc["b4"], x, img, f, down=1,
                                      stencils=stencils)
    return x, feats


def synthesis_block_apply(p: SynthesisBlock, x: torch.Tensor,
                          img: torch.Tensor, skip: torch.Tensor, f,
                          stencils: Stencils = PLAIN):
    """One up-sampling synthesis level (reference migan_inference.py:
    282-315): returns (features, accumulated rgb)."""
    x = sep_conv_apply(p.conv1, x, f, up=2, use_noise=True,
                       stencils=stencils)
    x = sep_conv_apply(p.conv2, x + skip, f, use_noise=True,
                       stencils=stencils)
    img = stencils.up(img, f) + conv1x1_apply(p.torgb, x)
    return x, img


def synthesis_first_apply(p: SynthesisBlock, x: torch.Tensor,
                          skip: torch.Tensor, f,
                          stencils: Stencils = PLAIN):
    """The 4x4 level (reference migan_inference.py:249-279)."""
    x = sep_conv_apply(p.conv1, x, f, stencils=stencils)
    x = sep_conv_apply(p.conv2, x + skip, f, stencils=stencils)
    return x, conv1x1_apply(p.torgb, x)


def synthesis_apply(syn: nn.ModuleDict, cfg: GeneratorConfig,
                    x: torch.Tensor, feats: Dict[int, torch.Tensor], f,
                    stencils: Stencils = PLAIN):
    """Reference migan_inference.py:347-352."""
    x, img = synthesis_first_apply(syn["b4"], x, feats[4], f, stencils)
    for res in cfg.block_res[1:]:
        x, img = synthesis_block_apply(syn[f"b{res}"], x, img, feats[res], f,
                                       stencils)
    return img


@torch.no_grad()
def generator_apply(generator: Generator, x: torch.Tensor,
                    stencils: Stencils = PLAIN) -> torch.Tensor:
    """Plain forward (reference migan_inference.py:362-369). x [N, H, W, 4]
    of the generator's dtype and device, H and W multiples of
    2**(log2(resolution) - 2). Returns [N, H, W, 3]. `stencils` replaces
    the ops that read neighbouring rows (`parallel/spatial.py`)."""
    cfg = generator.cfg
    f = resample_filter(x.device)
    z, feats = encoder_apply(generator.encoder, cfg, x, f, stencils)
    return synthesis_apply(generator.synthesis, cfg, z, feats, f, stencils)


# The reference's Downsample2d / Upsample2d modules hold their fixed 4x4
# FIR filters as depthwise conv weights (reference migan_inference.py:
# 58-103), which its parameter count includes; this port computes them.
_FIR_ELEMENTS = 16


def count_params(generator: Generator) -> int:
    """Parameter count of the reference's `migan_inference.Generator` of
    this config (reference migan_inference.py:355): the learnable tensors
    (noise_const is a buffer, as there) plus the reference's fixed
    resampling filters, one 4x4 per channel of every resampled tensor."""
    cfg = generator.cfg
    n = sum(p.numel() for p in generator.parameters())
    resampled = sum(cfg.ch(r) for r in cfg.encode_res[:-1])       # down
    resampled += sum(cfg.ch(r) + cfg.rgb_n for r in cfg.block_res[1:])  # up
    return n + _FIR_ELEMENTS * resampled
