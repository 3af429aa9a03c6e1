"""Co-Mod-GAN, the MI-GAN distillation teacher, in PyTorch, NHWC at the
boundary.

Port of `migan_tpu/models/comodgan.py` (reference lib/model_zoo/
comodgan.py): a StyleGAN2 generator co-modulated by a global image code.
The encoder (discriminator blocks that keep conv0's output as the skip
feature, and an epilogue with dropout) gives per-resolution features and
a 1024-d code w0; every synthesis layer is modulated by concat([w, w0]).
Module paths follow the JAX pytree (`synthesis.b64.conv0.affine.weight`),
the reference's state_dict keys.

The teacher runs as a frozen `eval()` module under `no_grad`
(`make_teacher_apply`), with random z and random noise drawn from the
caller's `torch.Generator`, as the reference's loss runs it
(loss.py:131-137). The demo CLI's `load_model` runs it as
`CoModGANForward` inside its entry module.

Spans (`utils/tracing.py`): `comodgan.forward`, and inside it
`comodgan.mapping`, `comodgan.encoder` and `comodgan.syn.b<r>` for each
synthesis level, 4 included. Counters: `comodgan.forwards` and
`comodgan.images`, the forwards and images through `CoModGANForward`.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import device_filter, get_unit, upsample2d
from ..utils import tracing
from .migan import DenseLayer, minibatch_std, randn
from .stylegan import (
    Conv2dLayer, DiscrimBlock, MappingConfig, MappingNetwork,
    SynthesisLayer, ToRGBLayer, _Block, discrim_block_apply, init_weights,
    mapping_apply,
)


@dataclass(frozen=True)
class CoModGANConfig:
    """Reference comodgan.py Encoder/Synthesis defaults + loss.py:68-111."""

    resolution: int = 256
    ic_n: int = 4
    rgb_n: int = 3
    z_dim: int = 512
    w_dim: int = 512
    w0_dim: int = 1024          # the global co-modulation code ("oc_n")
    ch_base: int = 32768
    ch_max: int = 512
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    activation: str = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
    use_dropout: bool = True
    has_extra_final_layer: bool = False
    mbstd_group_size: int = 0
    mbstd_c_n: int = 0

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

    @property
    def num_ws(self) -> int:
        # b4: 1 conv; each up-block: 2 convs; + the last torgb
        # (14 at 256, 16 at 512: reference comodgan.py:371-374)
        return 1 + 2 * (len(self.block_res) - 1) + 1

    @property
    def mapping_cfg(self) -> MappingConfig:
        return MappingConfig(z_dim=self.z_dim, w_dim=self.w_dim,
                             num_ws=self.num_ws, lr_multiplier=0.01,
                             w_avg_beta=0.995, activation=self.activation)


# ---------------------------------------------------------------------------
# Encoder (reference comodgan.py:114-204)
# ---------------------------------------------------------------------------

class Encoder(nn.Module):
    """`b{res}` discriminator blocks without the skip link (the top one
    with `fromrgb`) and `b4` (`conv`, `fc`, optional `out`)."""

    def __init__(self, cfg: CoModGANConfig):
        super().__init__()
        self.cfg = cfg
        res_list = cfg.encode_res
        for idx, (ri, rj) in enumerate(zip(res_list[:-1], res_list[1:])):
            ci, cj = cfg.ch(ri), cfg.ch(rj)
            setattr(self, f"b{ri}", DiscrimBlock(
                ci, ci, cj, rgb_n=cfg.ic_n if idx == 0 else None,
                reslink=False))
        c4 = cfg.ch(res_list[-1])
        b4 = {"conv": Conv2dLayer(c4 + cfg.mbstd_c_n, c4, 3),
              "fc": DenseLayer(c4 * 16, cfg.w0_dim)}
        if cfg.has_extra_final_layer:
            b4["out"] = DenseLayer(cfg.w0_dim, cfg.w0_dim)
        self.b4 = _Block(**b4)

    def forward(self, img: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None):
        return encoder_apply(self, img, dropout_generator=dropout_generator)


def encoder_apply(enc: Encoder, img: torch.Tensor, *,
                  dropout_generator: Optional[torch.Generator] = None):
    """(x_global [N, w0_dim], feats {res: NHWC}). Dropout runs only with a
    `dropout_generator` (training mode); the teacher runs without one,
    as the reference's `.eval()` teacher (loss.py:67,121)."""
    cfg = enc.cfg
    act = cfg.act
    f = cfg.filt(img.device)
    x = None
    feats: Dict[int, torch.Tensor] = {}
    for resi in cfg.encode_res[:-1]:
        x, feat = discrim_block_apply(getattr(enc, f"b{resi}"), x, img, act,
                                      f, return_feat=True)
        img = None
        feats[resi] = feat
    p4 = enc.b4
    if cfg.mbstd_c_n > 0:
        x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_c_n)
    feat = p4.conv(x, act=act)
    feats[4] = feat
    x = feat.permute(0, 3, 1, 2).reshape(feat.shape[0], -1)
    x = p4.fc(x, act=act)
    if hasattr(p4, "out"):
        x = p4.out(x)
    if cfg.use_dropout and dropout_generator is not None:
        keep = torch.rand(x.shape, generator=dropout_generator,
                          device=dropout_generator.device).to(x.device) < 0.5
        x = torch.where(keep, x / 0.5, torch.zeros_like(x))
    return x, feats


# ---------------------------------------------------------------------------
# Synthesis (reference comodgan.py:207-421)
# ---------------------------------------------------------------------------

class Synthesis(nn.Module):
    """`b4` (`fc` from w0, `conv`, `torgb`) and `b{res}` (`conv0` up,
    `conv1`, `torgb`), every layer modulated by concat([w, w0])."""

    def __init__(self, cfg: CoModGANConfig):
        super().__init__()
        self.cfg = cfg
        wd = cfg.w_dim + cfg.w0_dim
        c4 = cfg.ch(4)
        self.b4 = _Block(fc=DenseLayer(cfg.w0_dim, c4 * 16),
                         conv=SynthesisLayer(c4, c4, 3, wd, resolution=4),
                         torgb=ToRGBLayer(c4, cfg.rgb_n, 1, wd))
        self.span_names = {r: f"comodgan.syn.b{r}" for r in cfg.block_res}
        res_list = cfg.block_res
        for ri, rj in zip(res_list[:-1], res_list[1:]):
            ci, cj = cfg.ch(ri), cfg.ch(rj)
            setattr(self, f"b{rj}", _Block(
                conv0=SynthesisLayer(ci, cj, 3, wd, resolution=rj),
                conv1=SynthesisLayer(cj, cj, 3, wd, resolution=rj),
                torgb=ToRGBLayer(cj, cfg.rgb_n, 1, wd)))


def synthesis_apply(s: Synthesis, x_global: torch.Tensor, feats,
                    ws: torch.Tensor, *, noise_mode: str = "random",
                    generator: Optional[torch.Generator] = None,
                    return_intermediate: bool = False):
    """Reference comodgan.py:398-421. ws [N, num_ws, w_dim]. With
    return_intermediate, also {"res_to_rgb": {res: each level's torgb},
    "res_img": {res: the image so far}}."""
    cfg = s.cfg
    act = cfg.act
    f = cfg.filt(ws.device)
    noise = dict(noise_mode=noise_mode, generator=generator)
    w0 = x_global
    p4 = s.b4
    with tracing.span(s.span_names[4]):
        # fc -> [N, C, 4, 4] in torch order, then NHWC
        x = p4.fc(x_global, act=act)
        c4 = feats[4].shape[-1]
        x = x.reshape(x.shape[0], c4, 4, 4).permute(0, 2, 3, 1)
        x = x + feats[4]
        w_idx = 0
        x = p4.conv(x, torch.cat([ws[:, w_idx], w0], dim=1), act=act,
                    **noise)
        w_idx += 1
        img = p4.torgb(x, torch.cat([ws[:, w_idx], w0], dim=1))
    inter = {"res_to_rgb": {4: img}, "res_img": {4: img}}
    for res in cfg.block_res[1:]:
        p = getattr(s, f"b{res}")
        with tracing.span(s.span_names[res]):
            x = p.conv0(x, torch.cat([ws[:, w_idx], w0], dim=1), act=act,
                        up=2, resample_filter=f, **noise)
            x = x + feats[res]
            w_idx += 1
            x = p.conv1(x, torch.cat([ws[:, w_idx], w0], dim=1), act=act,
                        **noise)
            w_idx += 1
            img = upsample2d(img, f)
            y = p.torgb(x, torch.cat([ws[:, w_idx], w0], dim=1))
            img = img + y
        inter["res_to_rgb"][res] = y
        inter["res_img"][res] = img
    return (img, inter) if return_intermediate else img


# ---------------------------------------------------------------------------
# Generator (reference comodgan.py:424-460)
# ---------------------------------------------------------------------------

class CoModGANGenerator(nn.Module):
    """`mapping`, `encoder`, `synthesis`."""

    def __init__(self, cfg: CoModGANConfig = CoModGANConfig()):
        super().__init__()
        self.cfg = cfg
        self.mapping = MappingNetwork(cfg.mapping_cfg)
        self.encoder = Encoder(cfg)
        self.synthesis = Synthesis(cfg)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                truncation_psi: float = 1.0, noise_mode: str = "random",
                return_intermediate: bool = False):
        return generator_apply(self, x, z=z, generator=generator,
                               truncation_psi=truncation_psi,
                               noise_mode=noise_mode,
                               return_intermediate=return_intermediate)


def generator_apply(g: CoModGANGenerator, x: torch.Tensor, *,
                    z: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    truncation_psi: float = 1.0, noise_mode: str = "random",
                    return_intermediate: bool = False):
    """x [N, H, W, 4] = concat([mask - 0.5, rgb * mask]). z [N, z_dim] is
    drawn from `generator` when not given (before any noise)."""
    with tracing.span("comodgan.forward"):
        cfg = g.cfg
        if z is None:
            if generator is None:
                raise ValueError("comodgan: pass z or a torch.Generator")
            z = randn((x.shape[0], cfg.z_dim), generator, x.device,
                      torch.float32)
        with tracing.span("comodgan.mapping"):
            ws = mapping_apply(g.mapping, z, truncation_psi=truncation_psi)
        with tracing.span("comodgan.encoder"):
            x_global, feats = encoder_apply(g.encoder, x)
        return synthesis_apply(g.synthesis, x_global, feats, ws,
                               noise_mode=noise_mode, generator=generator,
                               return_intermediate=return_intermediate)


def generator_init(cfg: CoModGANConfig, generator: torch.Generator
                   ) -> CoModGANGenerator:
    """A Co-Mod-GAN generator with random weights (on the CPU)."""
    return init_weights(CoModGANGenerator(cfg), generator)


def make_teacher_apply(cfg: Optional[CoModGANConfig] = None):
    """The teacher contract of `train.loss.g_loss` in its tuple form:
    ``apply(module, x, generator) -> (img, {"res_to_rgb": {res: t},
    "res_img": ...})``, the module frozen in `eval()` and run under
    `no_grad`, z and noise random from `generator` (reference
    loss.py:131-137). `cfg` is the module's own; kept for the JAX
    package's signature."""
    def teacher_apply(module: CoModGANGenerator, x: torch.Tensor,
                      generator: torch.Generator):
        module.eval()
        with torch.no_grad():
            return generator_apply(module, x, generator=generator,
                                   noise_mode="random",
                                   return_intermediate=True)

    return teacher_apply


def load_comodgan(path: str, cfg: CoModGANConfig) -> CoModGANGenerator:
    """A float32 Co-Mod-GAN on the CPU from the JAX package's `.npz` or a
    reference state_dict (`.pt`/`.pth`)."""
    from ..io.train_weights import load_train_state

    g = CoModGANGenerator(cfg)
    g.load_state_dict(load_train_state(path), strict=True)
    return g


class CoModGANForward(nn.Module):
    """The Co-Mod-GAN generator as the demo CLI's `load_model` runs it,
    inside its entry module: x [N, H, W, 4] on the generator's device ->
    [N, H, W, 3], under `no_grad`, as the reference demo's comodgan path
    (scripts/demo.py:95-110). By default z is drawn per call and the noise
    is random, from a generator seeded 0 that advances with every call. A
    fixed `z` ([1, z_dim], broadcast over the batch) with noise_mode
    'const' (the checkpoint's `noise_const` buffers) makes the forward
    deterministic and comparable with a reference. Counts its forwards and
    images (`comodgan.forwards`, `comodgan.images`)."""

    def __init__(self, generator: CoModGANGenerator,
                 z: Optional[torch.Tensor] = None,
                 noise_mode: str = "random"):
        super().__init__()
        self.generator = generator
        dev = next(generator.parameters()).device
        self.z = None if z is None else torch.as_tensor(
            z, dtype=torch.float32, device=dev)
        self.noise_mode = noise_mode
        self.rng = torch.Generator(dev).manual_seed(0)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        tracing.add("comodgan.forwards")
        tracing.add("comodgan.images", n)
        z = None if self.z is None else self.z.expand(n, self.z.shape[-1])
        return generator_apply(self.generator, x, z=z, generator=self.rng,
                               noise_mode=self.noise_mode)


def load_comodgan_forward(model_name: str, model_path: str, ch_base=None,
                          ch_max=None, z=None, noise_mode: str = "random",
                          device: str = "cuda"):
    """The demo CLI's loader: (`CoModGANForward` on `device`, float32,
    resolution). ch_base and ch_max override the channel banks for
    reduced-width checkpoints."""
    m = re.fullmatch(r"comodgan-(\d+)", model_name)
    if m is None:
        raise ValueError(f"Unsupported model name: {model_name}")
    kw = {}
    if ch_base is not None:
        kw["ch_base"] = ch_base
    if ch_max is not None:
        kw["ch_max"] = ch_max
    cfg = CoModGANConfig(resolution=int(m.group(1)), **kw)
    g = load_comodgan(model_path, cfg).to(torch.device(device)).eval()
    return CoModGANForward(g, z, noise_mode), cfg.resolution
