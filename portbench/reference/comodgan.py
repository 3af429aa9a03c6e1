"""The Co-Mod-GAN generator in plain PyTorch, float32, NCHW.

Written from the published model: Zhao et al., "Large Scale Image
Completion via Co-Modulated Generative Adversarial Networks", ICLR 2021
(arXiv:2103.10428, github.com/zsyzzsoft/co-mod-gan), in the PyTorch form
that MI-GAN is distilled from (Picsart-AI-Research/MI-GAN,
`lib/model_zoo/comodgan.py` with the StyleGAN2 layers of
`lib/model_zoo/stylegan.py`):

- mapping: z scaled to unit second moment, 8 fully connected layers with
  learning-rate multiplier 0.01, the same w for every layer (truncation
  psi = 1 and no style mixing);
- encoder: StyleGAN2 discriminator blocks without the residual link,
  from `fromrgb` at the top, each keeping its first conv's output as the
  skip feature of its resolution and halving with the second; at 4x4 a
  conv (its output the 4x4 feature) and a fully connected layer to the
  global code w0 (dropout only in training: none here);
- synthesis: at 4x4 a fully connected layer from w0 plus the 4x4
  feature, then per level an up-2 modulated conv plus the encoder's
  feature and a modulated conv, each modulated by concat([w, w0]) with
  the level's constant noise; RGB summed over the levels, the image so
  far up-sampled by the FIR.

Every conv and dense weight is scaled by 1 / sqrt(fan in) at run time
(equalized learning rate). Activation: leaky ReLU 0.2, gain sqrt(2),
clamp 256. Resampling: the [1,3,3,1] FIR.

`param_shapes` lists the checkpoint's tensors under the names of the
published `state_dict` (the fixed `resample_filter` buffers left out),
`seeded_state` draws them from a seed on any device in one call, and
`forward` takes that state, an NHWC input and one latent and returns NHWC
RGB, like the program's entry point in its reproducible mode. With
`tf32=True` the convolutions and products may run in TF32: that is the
control of lower precision, not the reference. Imports no module of the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .generator import FIR_2D, act, precision, up2

# The configuration's keys that set the network's shape.
SHAPE_KEYS = ("resolution", "ch_base", "ch_max", "ic_n", "rgb_n", "z_dim",
              "w_dim", "w0_dim", "mapping_layers")
MAPPING_LR = 0.01


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
    """Name -> shape of every tensor of the checkpoint (OIHW conv weights,
    [out, in] dense weights, the buffers `w_avg` and `noise_const`)."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    wd = cfg["w_dim"] + cfg["w0_dim"]

    def dense(p, o, i):
        shapes[f"{p}.weight"] = (o, i)
        shapes[f"{p}.bias"] = (o,)

    def conv(p, o, i, k):
        shapes[f"{p}.weight"] = (o, i, k, k)
        shapes[f"{p}.bias"] = (o,)

    def modconv(p, o, i, k, noise_res=None):
        conv(p, o, i, k)
        if noise_res is not None:
            shapes[f"{p}.noise_strength"] = ()
            shapes[f"{p}.noise_const"] = (noise_res, noise_res)
        dense(f"{p}.affine", i, wd)

    shapes["mapping.w_avg"] = (cfg["w_dim"],)
    for i in range(cfg["mapping_layers"]):
        dense(f"mapping.fc{i}", cfg["w_dim"],
              cfg["z_dim"] if i == 0 else cfg["w_dim"])
    lv = levels(cfg)
    for idx, (ri, rj) in enumerate(zip(lv[:-1], lv[1:])):
        ci, cj = channels(cfg, ri), channels(cfg, rj)
        if idx == 0:
            conv(f"encoder.b{ri}.fromrgb", ci, cfg["ic_n"], 1)
        conv(f"encoder.b{ri}.conv0", ci, ci, 3)
        conv(f"encoder.b{ri}.conv1", cj, ci, 3)
    c4 = channels(cfg, 4)
    conv("encoder.b4.conv", c4, c4, 3)
    dense("encoder.b4.fc", cfg["w0_dim"], c4 * 16)
    dense("synthesis.b4.fc", c4 * 16, cfg["w0_dim"])
    modconv("synthesis.b4.conv", c4, c4, 3, noise_res=4)
    modconv("synthesis.b4.torgb", cfg["rgb_n"], c4, 1)
    up = lv[::-1]
    for ri, rj in zip(up[:-1], up[1:]):
        ci, cj = channels(cfg, ri), channels(cfg, rj)
        modconv(f"synthesis.b{rj}.conv0", cj, ci, 3, noise_res=rj)
        modconv(f"synthesis.b{rj}.conv1", cj, cj, 3, noise_res=rj)
        modconv(f"synthesis.b{rj}.torgb", cfg["rgb_n"], cj, 1)
    return shapes


def count_params(cfg: dict) -> int:
    """Learnable parameters (`w_avg` and `noise_const` are buffers, as
    published)."""
    return sum(math.prod(s) for k, s in param_shapes(cfg).items()
               if not k.endswith(("noise_const", "w_avg")))


@torch.no_grad()
def seeded_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The checkpoint drawn from `seed` on `device`, float32, in one call
    of one generator, every tensor from N(0, 1): weights as initialised
    (a mapping weight divided by its learning-rate multiplier, as
    published), biases scaled by 0.1 (an affine's about 1, its init),
    noise strengths by 0.5, so that each is non-zero, as trained ones
    are."""
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    pool = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=gen, dtype=torch.float32, device=device)
    state, off = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        v = pool[off:off + n].view(s)
        off += n
        if k.endswith(".bias"):
            v = v * 0.1 + (1.0 if ".affine." in k else 0.0)
        elif k.endswith("noise_strength"):
            v = v * 0.5
        if k.startswith("mapping.fc"):
            v = v / MAPPING_LR
        state[k] = v.clone()
    return state


def _dense(s, p: str, x: torch.Tensor, lr: float = 1.0) -> torch.Tensor:
    w = s[f"{p}.weight"]
    return F.linear(x, w * (lr / math.sqrt(w.shape[1])), s[f"{p}.bias"] * lr)


def _conv(s, p: str, x: torch.Tensor, down: bool = False) -> torch.Tensor:
    """Equalized-lr conv + bias + activation; down-2 as the FIR (pad 2)
    followed by the stride-2 conv."""
    w = s[f"{p}.weight"]
    w = w * (1.0 / math.sqrt(w[0].numel()))
    if down:
        return act(F.conv2d(_fir(x, 2), w, s[f"{p}.bias"], stride=2))
    return act(F.conv2d(x, w, s[f"{p}.bias"], padding=w.shape[-1] // 2))


def _fir(x: torch.Tensor, pad: int, gain: float = 1.0) -> torch.Tensor:
    """The [1,3,3,1] FIR over each channel, `pad` zeros on every side."""
    c = x.shape[1]
    f = (FIR_2D * gain).to(x.device, x.dtype)[None, None].expand(c, 1, 4, 4)
    return F.conv2d(F.pad(x, [pad] * 4), f, groups=c)


def _modconv(s, p: str, x: torch.Tensor, wcat: torch.Tensor,
             up: bool = False, demodulate: bool = True) -> torch.Tensor:
    """The modulated conv as per-sample weights and one grouped conv over
    the batch: w * s, demodulated; up-2 as the stride-2 transposed conv
    followed by the FIR with gain 4. Then the noise, the bias and the
    activation (torgb, undemodulated: the bias alone)."""
    n, i = x.shape[:2]
    w = s[f"{p}.weight"]
    o, _, k, _ = w.shape
    styles = _dense(s, f"{p}.affine", wcat)                   # [N, I]
    if demodulate:
        # MI-GAN's pre-normalisation (its stylegan.py:145-147, taken from
        # StyleGAN3): each output's weights and all styles of the batch to
        # unit mean square. The scalar on the styles cancels in the
        # demodulation (but for its eps of 1e-8), so blocks of other
        # sizes compute the same images.
        w = w * w.square().mean(dim=(1, 2, 3), keepdim=True).rsqrt()
        styles = styles * styles.square().mean().rsqrt()
    else:
        styles = styles * (1.0 / math.sqrt(i * k * k))
    ww = w[None] * styles[:, None, :, None, None]            # [N, O, I, k, k]
    if demodulate:
        ww = ww * (ww.square().sum(dim=(2, 3, 4), keepdim=True)
                   + 1e-8).rsqrt()
    h, wd = x.shape[2:]
    x = x.reshape(1, n * i, h, wd)
    if up:
        # conv_transpose2d takes [in, out / groups, k, k] per group
        x = F.conv_transpose2d(x, ww.transpose(1, 2).reshape(n * i, o, k, k),
                               stride=2, groups=n)
        x = _fir(x.reshape(n, o, 2 * h + 1, 2 * wd + 1), 1, gain=4.0)
    else:
        x = F.conv2d(x, ww.reshape(n * o, i, k, k), padding=k // 2,
                     groups=n).reshape(n, o, h, wd)
    b = s[f"{p}.bias"][None, :, None, None]
    if not demodulate:
        return x + b
    x = x + (s[f"{p}.noise_const"] * s[f"{p}.noise_strength"])[None, None]
    return act(x + b)


@torch.no_grad()
def forward(cfg: dict, state: Dict[str, torch.Tensor], x: torch.Tensor,
            z: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """x [N, R, R, 4] = concat(mask - 0.5, rgb * mask), rgb in [-1, 1],
    mask 1 = known; z [1, z_dim] (one latent for the batch) or
    [N, z_dim] -> [N, R, R, 3], all float32 on the state's device, with
    each layer's constant noise."""
    s = state
    lv = levels(cfg)
    n = x.shape[0]
    with precision(tf32):
        # mapping
        w = z.float().expand(n, cfg["z_dim"])
        w = w * (w.square().mean(dim=1, keepdim=True) + 1e-8).rsqrt()
        for i in range(cfg["mapping_layers"]):
            w = act(_dense(s, f"mapping.fc{i}", w, MAPPING_LR))
        # encoder
        h = _conv(s, f"encoder.b{lv[0]}.fromrgb", x.permute(0, 3, 1, 2))
        feats = {}
        for r in lv[:-1]:
            feats[r] = _conv(s, f"encoder.b{r}.conv0", h)
            h = _conv(s, f"encoder.b{r}.conv1", feats[r], down=True)
        feats[4] = _conv(s, "encoder.b4.conv", h)
        w0 = act(_dense(s, "encoder.b4.fc", feats[4].flatten(1)))
        # synthesis, co-modulated by concat([w, w0])
        wcat = torch.cat([w, w0], dim=1)
        c4 = channels(cfg, 4)
        h = act(_dense(s, "synthesis.b4.fc", w0)).reshape(n, c4, 4, 4)
        h = _modconv(s, "synthesis.b4.conv", h + feats[4], wcat)
        rgb = _modconv(s, "synthesis.b4.torgb", h, wcat, demodulate=False)
        for r in lv[-2::-1]:
            p = f"synthesis.b{r}"
            h = _modconv(s, f"{p}.conv0", h, wcat, up=True) + feats[r]
            h = _modconv(s, f"{p}.conv1", h, wcat)
            rgb = up2(rgb) + _modconv(s, f"{p}.torgb", h, wcat,
                                      demodulate=False)
        return rgb.permute(0, 2, 3, 1).contiguous()
