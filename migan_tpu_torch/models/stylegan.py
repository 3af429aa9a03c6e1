"""StyleGAN2 building blocks in PyTorch, NHWC at the boundary.

Port of `migan_tpu/models/stylegan.py` (reference lib/model_zoo/
stylegan.py): the modulated conv, the conv / synthesis / torgb layers, the
8-layer mapping network with its `w_avg` buffer and truncation, the skip
generator and the discriminator blocks and epilogue. Co-Mod-GAN
(`models/comodgan.py`) is built from these.

Module paths follow the JAX pytree (`b64.conv1.affine.weight`), which are
the reference's state_dict keys. Layouts are torch's: conv weights OIHW,
dense [out, in], the synthesis `const` [C, 4, 4]; `io/train_weights.py`
maps them to the JAX package's. `noise_const` and `w_avg` are buffers,
not parameters, as in the reference.

`modulated_conv2d` takes the JAX package's formulation (scale the
activations by the styles, one shared-weight conv, scale by the
demodulation coefficients; numerically the reference's grouped conv) and
its layouts: x NHWC, weight HWIO.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import (conv2d_resample, device_filter, get_unit, setup_filter,
                   upsample2d)
from .migan import DenseLayer, minibatch_std, randn

NOISE_MODES = ("random", "const", "none")


# ---------------------------------------------------------------------------
# Modulated convolution (reference stylegan.py:102-195)
# ---------------------------------------------------------------------------

def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     styles: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, up: int = 1,
                     down: int = 1, padding: int = 0, resample_filter=None,
                     demodulate: bool = True,
                     flip_weight: bool = True) -> torch.Tensor:
    """x [N, H, W, I], weight [kh, kw, I, O], styles [N, I]."""
    kh, kw, in_channels, _ = weight.shape
    if x.dtype == torch.bfloat16 and demodulate:
        # pre-normalize against overflow below float32 (reference
        # stylegan.py:134-138, fp16 there)
        w_norm = weight.abs().amax(dim=(0, 1, 2), keepdim=True)
        weight = weight * (1.0 / math.sqrt(in_channels * kh * kw) / w_norm)
        styles = styles / styles.abs().amax(dim=1, keepdim=True)
    dcoefs = None
    if demodulate:
        # StyleGAN3-style pre-normalization (reference stylegan.py:145-147)
        weight = weight * torch.rsqrt(
            weight.square().mean(dim=(0, 1, 2), keepdim=True))
        styles = styles * torch.rsqrt(styles.square().mean())
        # dcoef[n, o] = rsqrt(sum_{k,i} (w s)^2 + eps): one [N,I]x[I,O]
        w2 = weight.square().sum(dim=(0, 1))
        dcoefs = torch.rsqrt(styles.square() @ w2 + 1e-8)
    x = x * styles.to(x.dtype)[:, None, None, :]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=padding, flip_weight=flip_weight)
    if dcoefs is not None:
        x = x * dcoefs.to(x.dtype)[:, None, None, :]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class Conv2dLayer(nn.Module):
    """Equalized-lr conv (reference stylegan.py:198-243): weight OIHW,
    scaled by 1 / sqrt(fan_in) at forward time."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor, act=None, up: int = 1, down: int = 1,
                resample_filter=None, gain: float = 1.0) -> torch.Tensor:
        oc, ic, kh, kw = self.weight.shape
        w = (self.weight * (1.0 / math.sqrt(ic * kh * kw))).permute(
            2, 3, 1, 0)
        x = conv2d_resample(x, w.to(x.dtype), f=resample_filter, up=up,
                            down=down, padding=kh // 2,
                            flip_weight=(up == 1))
        if self.bias is not None:
            x = x + self.bias.to(x.dtype)
        return act(x, gain=gain) if act is not None else x * gain


class SynthesisLayer(nn.Module):
    """Modulated conv with its style affine and noise (reference
    stylegan.py:247-310). The conv weight is used raw: demodulation
    removes its scale."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, w_dim: int, resolution: int,
                 use_noise: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.affine = DenseLayer(w_dim, in_channels, bias_init=1.0)
        self.use_noise = use_noise
        if use_noise:
            self.register_buffer("noise_const",
                                 torch.empty(resolution, resolution))
            self.noise_strength = nn.Parameter(torch.empty(()))

    def forward(self, x: torch.Tensor, w: torch.Tensor, act=None,
                up: int = 1, resample_filter=None, gain: float = 1.0,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if noise_mode not in NOISE_MODES:
            raise ValueError(f"noise_mode {noise_mode!r}")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            if generator is None:
                raise ValueError("noise_mode='random' needs a "
                                 "torch.Generator")
            n, h, w_ = x.shape[0], x.shape[1] * up, x.shape[2] * up
            noise = (randn((n, h, w_, 1), generator, x.device, x.dtype)
                     * self.noise_strength)
        elif self.use_noise and noise_mode == "const":
            noise = (self.noise_const * self.noise_strength)[None, :, :,
                                                             None]
        k = self.weight.shape[-1]
        x = modulated_conv2d(x, self.weight.permute(2, 3, 1, 0), styles,
                             noise=noise, up=up, padding=k // 2,
                             resample_filter=resample_filter,
                             flip_weight=(up == 1))
        x = x + self.bias.to(x.dtype)
        return act(x, gain=gain) if act is not None else x * gain


class ToRGBLayer(nn.Module):
    """Modulated 1x1 conv without demodulation, styles scaled by the
    weight gain (reference stylegan.py:313-344)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, w_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.affine = DenseLayer(w_dim, in_channels, bias_init=1.0)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        oc, ic, kh, kw = self.weight.shape
        styles = self.affine(w) * (1.0 / math.sqrt(ic * kh * kw))
        x = modulated_conv2d(x, self.weight.permute(2, 3, 1, 0), styles,
                             demodulate=False)
        return x + self.bias.to(x.dtype)


class _Block(nn.Module):
    """A named group of layers (one resolution level)."""

    def __init__(self, **layers: nn.Module):
        super().__init__()
        for name, layer in layers.items():
            setattr(self, name, layer)


# ---------------------------------------------------------------------------
# Mapping network (reference stylegan.py:355-439)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MappingConfig:
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    num_ws: Optional[int] = 14
    num_layers: int = 8
    activation: str = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
    lr_multiplier: float = 0.01
    w_avg_beta: Optional[float] = 0.995


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1,
                         eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class MappingNetwork(nn.Module):
    """`fc0..fc{num_layers-1}` and the `w_avg` buffer."""

    def __init__(self, cfg: MappingConfig = MappingConfig()):
        super().__init__()
        self.cfg = cfg
        feats = [cfg.z_dim] + [cfg.w_dim] * cfg.num_layers
        for i in range(cfg.num_layers):
            setattr(self, f"fc{i}", DenseLayer(feats[i], feats[i + 1],
                                               lr_multi=cfg.lr_multiplier))
        if cfg.num_ws is not None and cfg.w_avg_beta is not None:
            self.register_buffer("w_avg", torch.empty(cfg.w_dim))

    def forward(self, z: torch.Tensor, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                update_w_avg: bool = False):
        return mapping_apply(self, z, truncation_psi=truncation_psi,
                             truncation_cutoff=truncation_cutoff,
                             update_w_avg=update_w_avg)


def mapping_apply(m: MappingNetwork, z: torch.Tensor, *,
                  truncation_psi: float = 1.0,
                  truncation_cutoff: Optional[int] = None,
                  update_w_avg: bool = False):
    """ws [N, num_ws, w_dim] (and the new w_avg when update_w_avg; the
    buffer itself is not written)."""
    cfg = m.cfg
    act = get_unit(cfg.activation)
    x = normalize_2nd_moment(z.float())
    for i in range(cfg.num_layers):
        x = getattr(m, f"fc{i}")(x, act=act)
    new_w_avg = None
    if update_w_avg and cfg.w_avg_beta is not None:
        mean_w = x.detach().mean(dim=0)
        new_w_avg = mean_w + cfg.w_avg_beta * (m.w_avg - mean_w)
    if cfg.num_ws is not None:
        x = x[:, None, :].repeat(1, cfg.num_ws, 1)
    if truncation_psi != 1:
        w_avg = m.w_avg
        if cfg.num_ws is None or truncation_cutoff is None:
            x = w_avg + truncation_psi * (x - w_avg)
        else:
            head = w_avg + truncation_psi * (x[:, :truncation_cutoff]
                                             - w_avg)
            x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
    if update_w_avg:
        return x, new_w_avg
    return x


# ---------------------------------------------------------------------------
# Synthesis and discriminator (reference stylegan.py:446-856)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StyleGANConfig:
    w_dim: int = 512
    resolution: int = 256
    rgb_n: int = 3
    ch_base: int = 16384
    ch_max: int = 512
    ic_n: int = 3   # discriminator input channels
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    activation: str = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
    mbstd_group_size: int = 4
    mbstd_c_n: int = 1

    @property
    def log2res(self) -> int:
        l = int(math.log2(self.resolution))
        if 2 ** l != self.resolution:
            raise ValueError(f"resolution {self.resolution} not a power of 2")
        return l

    @property
    def block_res(self):
        return [2 ** i for i in range(2, self.log2res + 1)]

    @property
    def encode_res(self):
        return [2 ** i for i in range(self.log2res, 1, -1)]

    def ch(self, res: int) -> int:
        return min(self.ch_base // res, self.ch_max)

    @property
    def act(self):
        return get_unit(self.activation)

    def filt(self, device=None) -> torch.Tensor:
        return device_filter(self.resample_filter, device)

    @property
    def num_ws(self) -> int:
        # 2 convs per up-block + 1 for b4's conv + 1 torgb of the last block
        return 1 + 2 * (len(self.block_res) - 1) + 1


class SynthesisNetwork(nn.Module):
    """The skip-architecture synthesis: `b4` (`const`, `conv1`, `torgb`),
    `b{res}` (`conv0` up, `conv1`, `torgb`)."""

    def __init__(self, cfg: StyleGANConfig = StyleGANConfig()):
        super().__init__()
        self.cfg = cfg
        for res in cfg.block_res:
            oc = cfg.ch(res)
            layers = {}
            if res == 4:
                const = nn.Parameter(torch.empty(oc, res, res))
            else:
                layers["conv0"] = SynthesisLayer(cfg.ch(res // 2), oc, 3,
                                                 cfg.w_dim, res)
            layers["conv1"] = SynthesisLayer(oc, oc, 3, cfg.w_dim, res)
            layers["torgb"] = ToRGBLayer(oc, cfg.rgb_n, 1, cfg.w_dim)
            block = _Block(**layers)
            if res == 4:
                block.const = const
            setattr(self, f"b{res}", block)

    def forward(self, ws: torch.Tensor, noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        return synthesis_apply(self, ws, noise_mode=noise_mode,
                               generator=generator)


def synthesis_apply(s: SynthesisNetwork, ws: torch.Tensor, *,
                    noise_mode: str = "random",
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Reference stylegan.py:576-589. ws [N, num_ws, w_dim] -> NHWC."""
    cfg = s.cfg
    act = cfg.act
    f = cfg.filt(ws.device)
    noise = dict(noise_mode=noise_mode, generator=generator)
    x = img = None
    w_idx = 0
    for res in cfg.block_res:
        p = getattr(s, f"b{res}")
        if res == 4:
            x = p.const.permute(1, 2, 0)[None].repeat(ws.shape[0], 1, 1, 1)
        else:
            x = p.conv0(x, ws[:, w_idx], act=act, up=2, resample_filter=f,
                        **noise)
            w_idx += 1
        x = p.conv1(x, ws[:, w_idx], act=act, **noise)
        w_idx += 1
        if img is not None:
            img = upsample2d(img, f)
        y = p.torgb(x, ws[:, w_idx])
        img = img + y if img is not None else y
    return img


class StyleGANGenerator(nn.Module):
    """`mapping` + `synthesis`."""

    def __init__(self, map_cfg: MappingConfig, cfg: StyleGANConfig):
        super().__init__()
        self.mapping = MappingNetwork(map_cfg)
        self.synthesis = SynthesisNetwork(cfg)

    def forward(self, z: torch.Tensor, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None):
        ws = self.mapping(z, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, noise_mode=noise_mode,
                              generator=generator)


class DiscrimBlock(nn.Module):
    """`fromrgb` (top block only), `conv0`, `conv1` down-2 and, with
    reslink, a 1x1 `skip` (reference stylegan.py:640-698)."""

    def __init__(self, ic_n: int, mc_n: int, oc_n: int,
                 rgb_n: Optional[int] = None, reslink: bool = True):
        super().__init__()
        if rgb_n is not None:
            self.fromrgb = Conv2dLayer(rgb_n, mc_n, 1)
        self.conv0 = Conv2dLayer(ic_n, mc_n, 3)
        self.conv1 = Conv2dLayer(mc_n, oc_n, 3)
        if reslink:
            self.skip = Conv2dLayer(mc_n, oc_n, 1, bias=False)


def discrim_block_apply(p: DiscrimBlock, x, img, act, f,
                        return_feat: bool = False):
    """Reference stylegan.py:672-698 / comodgan.py:35-61 (the feature
    variant returns conv0's output too)."""
    if hasattr(p, "fromrgb"):
        y = p.fromrgb(img, act=act)
        x = x + y if x is not None else y
    if hasattr(p, "skip"):
        y = p.skip(x, down=2, resample_filter=f, gain=math.sqrt(0.5))
        feat = p.conv0(x, act=act)
        x = p.conv1(feat, act=act, down=2, resample_filter=f,
                    gain=math.sqrt(0.5))
        x = y + x
    else:
        feat = p.conv0(x, act=act)
        x = p.conv1(feat, act=act, down=2, resample_filter=f)
    return (x, feat) if return_feat else x


class Discriminator(nn.Module):
    """`b{res}` blocks (res = resolution..8) and the `b4` epilogue
    (`conv` after the minibatch std, `fc`, `out`)."""

    def __init__(self, cfg: StyleGANConfig = StyleGANConfig()):
        super().__init__()
        self.cfg = cfg
        res_list = cfg.encode_res
        for idx, (ri, rj) in enumerate(zip(res_list[:-1], res_list[1:])):
            ci, cj = cfg.ch(ri), cfg.ch(rj)
            setattr(self, f"b{ri}", DiscrimBlock(
                ci, ci, cj, rgb_n=cfg.ic_n if idx == 0 else None))
        c4 = cfg.ch(res_list[-1])
        self.b4 = _Block(conv=Conv2dLayer(c4 + cfg.mbstd_c_n, c4, 3),
                         fc=DenseLayer(c4 * 16, c4),
                         out=DenseLayer(c4, 1))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return discriminator_apply(self, img)


def discriminator_apply(d: Discriminator, img: torch.Tensor
                        ) -> torch.Tensor:
    """Reference stylegan.py:760-772. img NHWC -> logits [N, 1]."""
    cfg = d.cfg
    act = cfg.act
    f = cfg.filt(img.device)
    x = None
    for resi in cfg.encode_res[:-1]:
        x = discrim_block_apply(getattr(d, f"b{resi}"), x, img, act, f)
        img = None
    p = d.b4
    if cfg.mbstd_c_n > 0:
        x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_c_n)
    x = p.conv(x, act=act)
    # flattened in torch's NCHW order (C, H, W), as the reference's fc
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    x = p.fc(x, act=act)
    return p.out(x)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator
                 ) -> nn.Module:
    """The JAX package's initial statistics, drawn from `generator`: conv
    weights and `const` ~ N(0, 1), biases 0, dense weights N(0, 1) /
    lr_multi with their bias_init, noise_const ~ N(0, 1), noise_strength
    and w_avg 0."""
    for m in module.modules():
        if isinstance(m, (Conv2dLayer, SynthesisLayer, ToRGBLayer)):
            m.weight.normal_(generator=generator)
            if m.bias is not None:
                m.bias.zero_()
            if getattr(m, "use_noise", False):
                m.noise_const.normal_(generator=generator)
                m.noise_strength.zero_()
        elif isinstance(m, DenseLayer):
            m.weight.normal_(generator=generator).div_(m.lr_multi)
            if m.bias is not None:
                m.bias.fill_(m.bias_init)
        elif isinstance(m, MappingNetwork) and hasattr(m, "w_avg"):
            m.w_avg.zero_()
        if isinstance(getattr(m, "const", None), nn.Parameter):
            m.const.normal_(generator=generator)
    return module
