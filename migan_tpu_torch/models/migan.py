"""MI-GAN training networks in PyTorch, NHWC at the boundary.

Port of `migan_tpu/models/migan.py` (reference lib/model_zoo/migan.py):
the encoder/synthesis generator and the StyleGAN2-style discriminator,
built from one conv layer that has

  - N-tensor re-parametrization, weight = (w0 + ... + wN-1) / sqrt(N),
    held as one parameter `w_stack` [N, O, I/g, kh, kw] (the reference's
    `w0..wN-1`, OIHW each; `io/train_weights.py` maps between the two);
  - per-output-channel weight normalization at forward time,
    w * rsqrt(sum(w^2) + 1e-8);
  - FIR up/down-sampling through `ops.conv2d_resample`;
  - noise (random from an explicit `torch.Generator`, the trained
    `noise_const` buffer, or none), bias and the activation with a
    runtime gain.

Module paths follow the JAX pytree (`encoder.b64.conv1.conv1.w_stack`),
which are the reference's state_dict keys but for the re-param tensors.
The synthesis also returns the per-resolution torgb outputs and images
(`res_to_rgb`, `res_img`) that the distillation loss reads.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import parallel
from ..ops import conv2d_resample, device_filter, get_unit, upsample2d

NOISE_MODES = ("random", "const", "none")


@dataclass(frozen=True)
class MiganConfig:
    """Architecture flags (reference configs/model/migan.yaml)."""

    resolution: int = 256
    ic_n: int = 4
    rgb_n: int = 3
    ch_base: int = 32768
    ch_max: int = 512
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    activation: str = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
    depthwise: bool = True
    reparametrize: bool = True
    num_reparam_tensors: int = 9
    # discriminator only
    mbstd_group_size: int = 4
    mbstd_c_n: int = 1

    @property
    def log2res(self) -> int:
        l = int(math.log2(self.resolution))
        if 2 ** l != self.resolution:
            raise ValueError(f"resolution {self.resolution} not a power of 2")
        return l

    @property
    def encode_res(self):
        return [2 ** i for i in range(self.log2res, 1, -1)]

    @property
    def block_res(self):
        return [2 ** i for i in range(2, self.log2res + 1)]

    def ch(self, res: int) -> int:
        return min(self.ch_base // res, self.ch_max)

    @property
    def act(self):
        return get_unit(self.activation)

    def filt(self, device=None) -> torch.Tensor:
        return device_filter(self.resample_filter, device)


def randn(shape, generator: torch.Generator, device,
          dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) draws of `shape` from `generator`, made on the generator's
    device and moved to `device`: the stream depends on the generator
    alone, so a CPU generator gives a run on the card the CPU run's
    noise.

    Under data parallelism `shape[0]` is this rank's share of the batch:
    each rank draws the global batch's ``[shape[0] * world, ...]`` from
    its generator (in the same state on every rank) and keeps its own
    rows, so P ranks draw what one process draws for the global batch."""
    n, p = shape[0], parallel.world()
    r = torch.randn((n * p, *shape[1:]), generator=generator,
                    device=generator.device, dtype=dtype)
    if p > 1:
        r = r[parallel.rank() * n:(parallel.rank() + 1) * n]
    return r.to(device)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class DenseLayer(nn.Module):
    """Equalized-learning-rate dense layer (reference migan.py:14-48):
    weight [out, in] scaled by lr_multi / sqrt(in) at forward time."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, bias_init: float = 0.0,
                 lr_multi: float = 1.0):
        super().__init__()
        self.lr_multi = lr_multi
        self.bias_init = float(bias_init)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor, act=None,
                gain: float = 1.0) -> torch.Tensor:
        w = self.weight.to(x.dtype) * (self.lr_multi
                                       / math.sqrt(self.weight.shape[1]))
        x = x @ w.t()
        if self.bias is not None:
            b = self.bias.to(x.dtype)
            x = x + (b * self.lr_multi if self.lr_multi != 1.0 else b)
        return act(x, gain=gain) if act is not None else x


class ConvLayer(nn.Module):
    """The reference's training Conv2d (migan.py:54-146): re-param sum,
    weight norm, resampling conv, noise, bias, activation with gain."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 cfg: MiganConfig, bias: bool = True, groups: int = 1,
                 reparametrize: Optional[bool] = None,
                 noise_res: Optional[int] = None):
        super().__init__()
        reparam = cfg.reparametrize if reparametrize is None else reparametrize
        shape = (out_channels, in_channels // groups, kernel_size,
                 kernel_size)
        self.groups = groups
        self.reparametrized = reparam
        if reparam:
            self.w_stack = nn.Parameter(
                torch.empty(cfg.num_reparam_tensors, *shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.use_noise = noise_res is not None
        if self.use_noise:
            self.register_buffer("noise_const",
                                 torch.empty(noise_res, noise_res))
            self.noise_strength = nn.Parameter(torch.empty(()))

    def effective_weight(self) -> torch.Tensor:
        """Re-param sum and weight norm (reference migan.py:108-115): the
        OIHW weight the conv uses."""
        if self.reparametrized:
            w = self.w_stack.sum(dim=0) / math.sqrt(self.w_stack.shape[0])
        else:
            w = self.weight
        return w * torch.rsqrt(w.square().sum(dim=(1, 2, 3), keepdim=True)
                               + 1e-8)

    def _noise(self, x: torch.Tensor, noise_mode: str,
               generator: Optional[torch.Generator]):
        n, h, w = x.shape[:3]
        if noise_mode == "random":
            if generator is None:
                raise ValueError("noise_mode='random' needs a "
                                 "torch.Generator")
            r = randn((n, h, w, 1), generator, x.device, x.dtype)
            return r * self.noise_strength.to(x.dtype)
        nc = self.noise_const
        nh, nw = nc.shape
        if (h, w) != (nh, nw):
            # tiled where the plane is smaller (migan_tpu/models/migan.py
            # :193-199), cropped where it is larger
            nc = nc.tile((max(1, -(-h // nh)), max(1, -(-w // nw))))[:h, :w]
        return (nc * self.noise_strength).to(x.dtype)[None, :, :, None]

    def forward(self, x: torch.Tensor, *, act=None,
                f: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                gain: float = 1.0, noise_mode: str = "none",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if noise_mode not in NOISE_MODES:
            raise ValueError(f"noise_mode {noise_mode!r}")
        w = self.effective_weight()
        x = conv2d_resample(x, w.permute(2, 3, 1, 0).to(x.dtype), f=f, up=up,
                            down=down, padding=w.shape[-1] // 2,
                            groups=self.groups, flip_weight=(up == 1))
        if self.use_noise and noise_mode != "none":
            x = x + self._noise(x, noise_mode, generator)
        if self.bias is not None:
            x = x + self.bias.to(x.dtype)
        return act(x, gain=gain) if act is not None else x * gain


class SeparableConv(nn.Module):
    """Depthwise 3x3 `conv1` (+bias) and pointwise 1x1 `conv2` (no bias,
    the noise), both training ConvLayers (reference migan.py:152-200)."""

    def __init__(self, in_channels: int, out_channels: int, cfg: MiganConfig,
                 noise_res: Optional[int] = None):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3, cfg,
                               groups=in_channels)
        self.conv2 = ConvLayer(in_channels, out_channels, 1, cfg, bias=False,
                               noise_res=noise_res)

    def forward(self, x: torch.Tensor, *, act, f=None, up: int = 1,
                down: int = 1, gain: float = 1.0, noise_mode: str = "none",
                generator=None) -> torch.Tensor:
        x = self.conv1(x, act=act, gain=gain)
        return self.conv2(x, act=act, f=f, up=up, down=down, gain=gain,
                          noise_mode=noise_mode, generator=generator)


def _conv_or_sep(cfg: MiganConfig, ic: int, oc: int,
                 noise_res: Optional[int] = None) -> nn.Module:
    if cfg.depthwise:
        return SeparableConv(ic, oc, cfg, noise_res=noise_res)
    return ConvLayer(ic, oc, 3, cfg, noise_res=noise_res)


class _Block(nn.Module):
    """A named group of layers (a level of the encoder, synthesis or
    discriminator)."""

    def __init__(self, **layers: nn.Module):
        super().__init__()
        for name, layer in layers.items():
            setattr(self, name, layer)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

class Generator(nn.Module):
    """`encoder.b{res}` (res = resolution..4; the top one with a plain,
    never re-parametrized, `fromrgb`) and `synthesis.b{res}`
    (res = 4..resolution, with noise above 4), as in the JAX pytree."""

    def __init__(self, cfg: MiganConfig = MiganConfig()):
        super().__init__()
        self.cfg = cfg
        enc = {}
        res_list = cfg.encode_res
        for idx, (ri, rj) in enumerate(zip(res_list[:-1], res_list[1:])):
            ci, cj = cfg.ch(ri), cfg.ch(rj)
            layers = {}
            if idx == 0:
                # the reference does not thread reparametrize into the
                # encoder's fromrgb (migan.py:223-225), unlike D's
                layers["fromrgb"] = ConvLayer(cfg.ic_n, ci, 1, cfg,
                                              reparametrize=False)
            layers["conv1"] = _conv_or_sep(cfg, ci, ci)
            layers["conv2"] = _conv_or_sep(cfg, ci, cj)
            enc[f"b{ri}"] = _Block(**layers)
        c4 = cfg.ch(res_list[-1])
        enc["b4"] = _Block(conv1=_conv_or_sep(cfg, c4, c4),
                           conv2=_conv_or_sep(cfg, c4, c4))
        self.encoder = nn.ModuleDict(enc)

        syn = {"b4": _Block(conv1=_conv_or_sep(cfg, c4, c4),
                            conv2=_conv_or_sep(cfg, c4, c4),
                            torgb=ConvLayer(c4, cfg.rgb_n, 1, cfg))}
        res_list = cfg.block_res
        for ri, rj in zip(res_list[:-1], res_list[1:]):
            ci, cj = cfg.ch(ri), cfg.ch(rj)
            syn[f"b{rj}"] = _Block(conv1=_conv_or_sep(cfg, ci, cj, rj),
                                   conv2=_conv_or_sep(cfg, cj, cj, rj),
                                   torgb=ConvLayer(cj, cfg.rgb_n, 1, cfg))
        self.synthesis = nn.ModuleDict(syn)

    def forward(self, x: torch.Tensor, noise_mode: str = "random",
                generator: Optional[torch.Generator] = None,
                return_intermediate: bool = False):
        return generator_apply(self, x, noise_mode=noise_mode,
                               generator=generator,
                               return_intermediate=return_intermediate)


def encoder_apply(enc: nn.ModuleDict, cfg: MiganConfig, img: torch.Tensor,
                  f: torch.Tensor):
    """Reference migan.py:320-331: the bottleneck and the skip features."""
    act = cfg.act
    x = None
    feats: Dict[int, torch.Tensor] = {}
    for resi in cfg.encode_res[:-1]:
        p = enc[f"b{resi}"]
        if hasattr(p, "fromrgb"):
            y = p.fromrgb(img, act=act)
            x = x + y if x is not None else y
        feat = p.conv1(x, act=act)
        x = p.conv2(feat, act=act, f=f, down=2)
        feats[resi] = feat
    p = enc["b4"]
    feat = p.conv1(x, act=act)
    x = p.conv2(feat, act=act)
    feats[4] = feat
    return x, feats


def synthesis_apply(syn: nn.ModuleDict, cfg: MiganConfig, x: torch.Tensor,
                    feats: Dict[int, torch.Tensor], f: torch.Tensor, *,
                    noise_mode: str, generator=None):
    """Reference migan.py:516-524: (img, intermediates)."""
    act = cfg.act
    noise = dict(noise_mode=noise_mode, generator=generator)
    p4 = syn["b4"]
    x = p4.conv1(x, act=act)
    x = p4.conv2(x + feats[4], act=act, **noise)
    img = p4.torgb(x)
    inter = {"res_to_rgb": {4: img}, "res_img": {4: img}}
    for res in cfg.block_res[1:]:
        p = syn[f"b{res}"]
        x = p.conv1(x, act=act, f=f, up=2, **noise)
        x = p.conv2(x + feats[res], act=act, **noise)
        img = upsample2d(img, f)
        y = p.torgb(x)
        img = img + y
        inter["res_to_rgb"][res] = y
        inter["res_img"][res] = img
    return img, inter


def generator_apply(g: Generator, x: torch.Tensor, *,
                    noise_mode: str = "random",
                    generator: Optional[torch.Generator] = None,
                    return_intermediate: bool = False):
    """Reference migan.py:546-555. x: [N, H, W, 4] NHWC -> [N, H, W, 3]
    (and the intermediates). noise_mode 'random' draws from `generator`
    (on its own device, see `randn`)."""
    f = g.cfg.filt(x.device)
    z, feats = encoder_apply(g.encoder, g.cfg, x, f)
    img, inter = synthesis_apply(g.synthesis, g.cfg, z, feats, f,
                                 noise_mode=noise_mode, generator=generator)
    return (img, inter) if return_intermediate else img


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------

def minibatch_std(x: torch.Tensor, group_size: Optional[int],
                  num_channels: int = 1) -> torch.Tensor:
    """NHWC minibatch-std layer (reference migan.py:624-644): groups
    [G, N // G] with G = min(group_size, N), statistics appended as
    `num_channels` channels.

    N is the global batch: under a process group of more than one rank
    the rows of every rank are gathered in rank order
    (`parallel.all_gather_rows`, differentiable), as the JAX package's
    program groups its global array, and each rank keeps the statistics
    of its own rows. (The reference's DDP takes them per GPU.)"""
    n, h, w, c = x.shape
    p = parallel.world()
    xs = parallel.all_gather_rows(x) if p > 1 else x
    big_n = xs.shape[0]
    g = min(group_size, big_n) if group_size is not None else big_n
    fch = num_channels
    y = xs.reshape(g, big_n // g, h, w, fch, c // fch)
    y = y - y.mean(dim=0)
    y = (y.square().mean(dim=0) + 1e-8).sqrt()
    y = y.mean(dim=(1, 2, 4))                    # [N // g, F]
    y = y.repeat(g, 1)                           # row i: column i % (N // g)
    if p > 1:
        y = y[parallel.rank() * n:(parallel.rank() + 1) * n]
    y = y.reshape(-1, 1, 1, fch).repeat(1, h, w, 1)
    return torch.cat([x, y.to(x.dtype)], dim=-1)


class Discriminator(nn.Module):
    """`b{res}` (res = resolution..8; conv1, conv2, a 1x1 `skip`, the top
    one with a `fromrgb` that is re-parametrized as the config says) and
    `b4` (`conv` after the minibatch std, `fc`, `out`)."""

    def __init__(self, cfg: MiganConfig = MiganConfig()):
        super().__init__()
        self.cfg = cfg
        blocks = {}
        res_list = cfg.encode_res
        for idx, (ri, rj) in enumerate(zip(res_list[:-1], res_list[1:])):
            ci, cj = cfg.ch(ri), cfg.ch(rj)
            layers = {}
            if idx == 0:
                layers["fromrgb"] = ConvLayer(cfg.ic_n, ci, 1, cfg)
            layers["conv1"] = _conv_or_sep(cfg, ci, ci)
            layers["conv2"] = _conv_or_sep(cfg, ci, cj)
            layers["skip"] = ConvLayer(ci, cj, 1, cfg, bias=False)
            blocks[f"b{ri}"] = _Block(**layers)
        c4 = cfg.ch(res_list[-1])
        blocks["b4"] = _Block(conv=_conv_or_sep(cfg, c4 + cfg.mbstd_c_n, c4),
                              fc=DenseLayer(c4 * 16, c4),
                              out=DenseLayer(c4, 1))
        for name, block in blocks.items():      # state_dict keys b64.…
            setattr(self, name, block)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return discriminator_apply(self, img)


def discriminator_apply(d: Discriminator, img: torch.Tensor) -> torch.Tensor:
    """Reference migan.py:758-764. img [N, H, W, ic_n] -> logits [N, 1]."""
    cfg = d.cfg
    act = cfg.act
    f = cfg.filt(img.device)
    sqrt_half = math.sqrt(0.5)
    x = None
    for resi in cfg.encode_res[:-1]:
        p = getattr(d, f"b{resi}")
        if hasattr(p, "fromrgb"):
            y = p.fromrgb(img, act=act)
            x = x + y if x is not None else y
        y = p.skip(x, f=f, down=2, gain=sqrt_half)
        x = p.conv1(x, act=act)
        x = p.conv2(x, act=act, f=f, down=2, gain=sqrt_half)
        x = y + x
    p = d.b4
    if cfg.mbstd_c_n > 0:
        x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_c_n)
    x = p.conv(x, act=act)
    # flattened in torch's NCHW order (C, H, W), as the reference's fc
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    x = p.fc(x, act=act)
    return p.out(x)


# ---------------------------------------------------------------------------
# Initialization and counting
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator
                 ) -> nn.Module:
    """The JAX package's initial statistics, drawn from `generator`:
    weights (and re-param tensors) ~ N(0, 1) (dense: / lr_multi), biases
    0 (dense: its bias_init), noise_const ~ N(0, 1), noise_strength 0."""
    for m in module.modules():
        if isinstance(m, ConvLayer):
            w = m.w_stack if m.reparametrized else m.weight
            w.normal_(generator=generator)
            if m.bias is not None:
                m.bias.zero_()
            if m.use_noise:
                m.noise_const.normal_(generator=generator)
                m.noise_strength.zero_()
        elif isinstance(m, DenseLayer):
            m.weight.normal_(generator=generator).div_(m.lr_multi)
            if m.bias is not None:
                m.bias.fill_(m.bias_init)
    return module


def generator_init(cfg: MiganConfig, generator: torch.Generator
                   ) -> Generator:
    """A training `Generator` with random weights (on the CPU)."""
    return init_weights(Generator(cfg), generator)


def discriminator_init(cfg: MiganConfig, generator: torch.Generator
                       ) -> Discriminator:
    return init_weights(Discriminator(cfg), generator)


def count_params(module: nn.Module) -> int:
    """Learnable elements (nn.Parameters; noise_const is a buffer, as in
    the reference), the count the reference reports."""
    return sum(p.numel() for p in module.parameters())
