"""InceptionV3 feature extractor for FID, the pytorch_fid flavor of the
standalone evaluation (port of `migan_tpu/evalx/inception.py`; reference
scripts/evaluate_fid_lpips.py:216-218), NHWC in, [N, 2048] pool features
out.

`inception_apply`: input in [0, 1], resized to 299 x 299 bilinear, scaled
to [-1, 1]. The resize is the JAX package's, `jax.image.resize(...,
"bilinear")`, which antialiases when it shrinks (`ops/resize.py`); at a
512 input this is not what pytorch_fid computes (it does not antialias),
but the port is held against the JAX package. The training-time NVIDIA
TorchScript flavor comes with the trainer, which is its only caller.

The FID variant of InceptionV3 (avg-pool branches with
count_include_pad=False, a max-pool branch in Mixed_7c). BatchNorm is
folded into a per-channel scale and bias at import: each unit is conv (no
bias), x * scale + bias, ReLU. Plain PyTorch on cuDNN: the JAX package
runs this in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear

_BN_EPS = 1e-3
# `seeded_state_dict`: mean pool feature on 512² noise, and the units whose
# outputs Mixed_7c concatenates into the pool features
_SEEDED_FEATURE_MEAN = 0.3
_LAST_UNITS = ("branch1x1", "branch3x3_2a", "branch3x3_2b",
               "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool")


class Unit(nn.Module):
    """A folded conv + BatchNorm + ReLU unit (OIHW weight)."""

    def __init__(self, ic: int, oc: int, k=(1, 1), stride=(1, 1),
                 padding=(0, 0)):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(oc, ic, *k),
                                   requires_grad=False)
        self.scale = nn.Parameter(torch.ones(oc), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(oc), requires_grad=False)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                     padding=self.padding)
        y = (y * self.scale.to(x.dtype)[:, None, None]
             + self.bias.to(x.dtype)[:, None, None])
        return F.relu(y)


def _avgpool3_nopad(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _cat(*xs):
    return torch.cat(xs, dim=1)


class _Block(nn.Module):
    """An Inception block: named units, run in the forward of its kind."""

    def __init__(self, kind: str, units: Dict[str, Unit]):
        super().__init__()
        self.kind = kind
        for name, u in units.items():
            self.add_module(name, u)

    def forward(self, x):
        u = self._modules
        if self.kind == "A":
            b5 = u["branch5x5_2"](u["branch5x5_1"](x))
            b3 = u["branch3x3dbl_3"](u["branch3x3dbl_2"](
                u["branch3x3dbl_1"](x)))
            return _cat(u["branch1x1"](x), b5, b3,
                        u["branch_pool"](_avgpool3_nopad(x)))
        if self.kind == "B":
            bd = u["branch3x3dbl_3"](u["branch3x3dbl_2"](
                u["branch3x3dbl_1"](x)))
            return _cat(u["branch3x3"](x), bd, F.max_pool2d(x, 3, 2))
        if self.kind == "C":
            b7 = x
            for k in ("branch7x7_1", "branch7x7_2", "branch7x7_3"):
                b7 = u[k](b7)
            bd = x
            for i in range(1, 6):
                bd = u[f"branch7x7dbl_{i}"](bd)
            return _cat(u["branch1x1"](x), b7, bd,
                        u["branch_pool"](_avgpool3_nopad(x)))
        if self.kind == "D":
            b3 = u["branch3x3_2"](u["branch3x3_1"](x))
            b7 = x
            for i in range(1, 5):
                b7 = u[f"branch7x7x3_{i}"](b7)
            return _cat(b3, b7, F.max_pool2d(x, 3, 2))
        # E1 (Mixed_7b, count_include_pad=False avg) / E2 (Mixed_7c, max)
        b3 = u["branch3x3_1"](x)
        b3 = _cat(u["branch3x3_2a"](b3), u["branch3x3_2b"](b3))
        bd = u["branch3x3dbl_2"](u["branch3x3dbl_1"](x))
        bd = _cat(u["branch3x3dbl_3a"](bd), u["branch3x3dbl_3b"](bd))
        bp = (F.max_pool2d(x, 3, 1, 1) if self.kind == "E2"
              else _avgpool3_nopad(x))
        return _cat(u["branch1x1"](x), b3, bd, u["branch_pool"](bp))


# (name, kind, in channels, pool features / c7)
_MIXED = [
    ("Mixed_5b", "A", 192, 32),
    ("Mixed_5c", "A", 256, 64),
    ("Mixed_5d", "A", 288, 64),
    ("Mixed_6a", "B", 288, None),
    ("Mixed_6b", "C", 768, 128),
    ("Mixed_6c", "C", 768, 160),
    ("Mixed_6d", "C", 768, 160),
    ("Mixed_6e", "C", 768, 192),
    ("Mixed_7a", "D", 768, None),
    ("Mixed_7b", "E1", 1280, None),
    ("Mixed_7c", "E2", 2048, None),
]


def _block_units(kind: str, ic: int, pf) -> Dict[str, Unit]:
    """Units of one block: (in, out, kernel, stride, padding)."""
    U = Unit
    if kind == "A":
        return {"branch1x1": U(ic, 64),
                "branch5x5_1": U(ic, 48),
                "branch5x5_2": U(48, 64, (5, 5), padding=(2, 2)),
                "branch3x3dbl_1": U(ic, 64),
                "branch3x3dbl_2": U(64, 96, (3, 3), padding=(1, 1)),
                "branch3x3dbl_3": U(96, 96, (3, 3), padding=(1, 1)),
                "branch_pool": U(ic, pf)}
    if kind == "B":
        return {"branch3x3": U(ic, 384, (3, 3), stride=(2, 2)),
                "branch3x3dbl_1": U(ic, 64),
                "branch3x3dbl_2": U(64, 96, (3, 3), padding=(1, 1)),
                "branch3x3dbl_3": U(96, 96, (3, 3), stride=(2, 2))}
    if kind == "C":
        c7, row, col = pf, ((1, 7), (1, 1), (0, 3)), ((7, 1), (1, 1), (3, 0))
        return {"branch1x1": U(ic, 192),
                "branch7x7_1": U(ic, c7),
                "branch7x7_2": U(c7, c7, *row),
                "branch7x7_3": U(c7, 192, *col),
                "branch7x7dbl_1": U(ic, c7),
                "branch7x7dbl_2": U(c7, c7, *col),
                "branch7x7dbl_3": U(c7, c7, *row),
                "branch7x7dbl_4": U(c7, c7, *col),
                "branch7x7dbl_5": U(c7, 192, *row),
                "branch_pool": U(ic, 192)}
    if kind == "D":
        return {"branch3x3_1": U(ic, 192),
                "branch3x3_2": U(192, 320, (3, 3), stride=(2, 2)),
                "branch7x7x3_1": U(ic, 192),
                "branch7x7x3_2": U(192, 192, (1, 7), padding=(0, 3)),
                "branch7x7x3_3": U(192, 192, (7, 1), padding=(3, 0)),
                "branch7x7x3_4": U(192, 192, (3, 3), stride=(2, 2))}
    return {"branch1x1": U(ic, 320),
            "branch3x3_1": U(ic, 384),
            "branch3x3_2a": U(384, 384, (1, 3), padding=(0, 1)),
            "branch3x3_2b": U(384, 384, (3, 1), padding=(1, 0)),
            "branch3x3dbl_1": U(ic, 448),
            "branch3x3dbl_2": U(448, 384, (3, 3), padding=(1, 1)),
            "branch3x3dbl_3a": U(384, 384, (1, 3), padding=(0, 1)),
            "branch3x3dbl_3b": U(384, 384, (3, 1), padding=(1, 0)),
            "branch_pool": U(ic, 192)}


class InceptionV3(nn.Module):
    """The FID InceptionV3 backbone with folded BatchNorm. Unit paths are
    torchvision's (`Mixed_5b.branch1x1`, ...), each holding `weight`,
    `scale` and `bias`."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = Unit(3, 32, (3, 3), stride=(2, 2))
        self.Conv2d_2a_3x3 = Unit(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = Unit(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = Unit(64, 80)
        self.Conv2d_4a_3x3 = Unit(80, 192, (3, 3))
        for name, kind, ic, pf in _MIXED:
            self.add_module(name, _Block(kind, _block_units(kind, ic, pf)))
        self.eval()

    def units(self) -> Dict[str, Unit]:
        """{unit path: Unit}, e.g. 'Conv2d_1a_3x3', 'Mixed_5b.branch1x1'."""
        return {k: m for k, m in self.named_modules() if isinstance(m, Unit)}

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC, already resized and normalised -> [N, 2048] float32."""
        x = x.permute(0, 3, 1, 2).contiguous()
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name, *_ in _MIXED:
            x = getattr(self, name)(x)
        # average pool, summed in float32 under bf16 compute
        return x.float().mean(dim=(2, 3))

    def jax_params(self) -> dict:
        """The JAX package's folded params of these weights, as numpy
        (`migan_tpu.evalx.inception` layout: w HWIO)."""
        params: dict = {}
        for path, u in self.units().items():
            node = params
            *parents, leaf = path.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = {
                "w": np.ascontiguousarray(
                    u.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)),
                "scale": u.scale.detach().cpu().numpy(),
                "bias": u.bias.detach().cpu().numpy()}
        return params


@torch.no_grad()
def inception_apply(model: InceptionV3, x: torch.Tensor, *,
                    resize_input: bool = True, normalize_input: bool = True,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """x: NHWC float in [0, 1] -> [N, 2048] pool features (float32).

    compute_dtype=torch.bfloat16 runs the resize and the conv stack in
    bf16, as the JAX package does (it casts before the resize)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if resize_input:
        x = resize_bilinear(x, (299, 299), antialias=True)
    if normalize_input:
        x = 2.0 * x - 1.0
    return model(x)


# ---------------------------------------------------------------------------
# Weight import, random init
# ---------------------------------------------------------------------------

def _fold(f: Mapping[str, np.ndarray], unit: Unit, where: str) -> None:
    """Load conv + BatchNorm arrays into a folded unit (numpy float32
    arithmetic, as the JAX importers)."""
    w = np.asarray(f["conv.weight"], np.float32)
    if tuple(w.shape) != tuple(unit.weight.shape):
        raise ValueError(f"{where}: kernel {w.shape} != expected "
                         f"{tuple(unit.weight.shape)}")
    oc = w.shape[0]
    gamma = np.asarray(f.get("bn.weight", np.ones((oc,), np.float32)))
    beta = np.asarray(f["bn.bias"])
    mean, var = np.asarray(f["bn.running_mean"]), np.asarray(
        f["bn.running_var"])
    scale = gamma / np.sqrt(var + _BN_EPS)
    bias = beta - mean * scale
    with torch.no_grad():
        unit.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        unit.scale.copy_(torch.from_numpy(scale.astype(np.float32)))
        unit.bias.copy_(torch.from_numpy(bias.astype(np.float32)))


def import_inception_state_dict(sd: Mapping[str, np.ndarray]) -> InceptionV3:
    """torchvision-named InceptionV3 state_dict (pytorch_fid's
    pt_inception weights, or torchvision's inception_v3) -> folded
    `InceptionV3`. fc and AuxLogits are ignored (FID reads pool
    features)."""
    units: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in sd.items():
        if key.startswith(("fc.", "AuxLogits.")) or "num_batches" in key:
            continue
        parts = key.split(".")
        units.setdefault(".".join(parts[:-2]), {})[
            ".".join(parts[-2:])] = np.asarray(val)
    model = InceptionV3()
    mine = model.units()
    if set(units) != set(mine):
        raise ValueError(f"state_dict units differ from InceptionV3's: "
                         f"{sorted(set(units) ^ set(mine))[:8]}")
    for path, f in units.items():
        _fold(f, mine[path], path)
    return model


def from_jax_params(params: Mapping) -> InceptionV3:
    """The JAX package's folded params (numpy or JAX arrays; w HWIO), as
    `inception_init` or its importers give them -> `InceptionV3`."""
    model = InceptionV3()
    with torch.no_grad():
        for path, u in model.units().items():
            p = params
            for part in path.split("."):
                p = p[part]
            u.weight.copy_(torch.tensor(
                np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)))
            u.scale.copy_(torch.tensor(np.asarray(p["scale"], np.float32)))
            u.bias.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))
    return model


def inception_init(seed: int = 0) -> InceptionV3:
    """Random weights from `seed` (structure tests and smoke runs only):
    normal / sqrt(fan_in), scale 1, bias 0."""
    gen = torch.Generator().manual_seed(seed)
    model = InceptionV3()
    with torch.no_grad():
        for u in model.units().values():
            u.weight.copy_(torch.randn(u.weight.shape, generator=gen)
                           / math.sqrt(u.weight[0].numel()))
    return model


@torch.no_grad()
def seeded_state_dict(seed: int, n_images: int = 4
                      ) -> Dict[str, torch.Tensor]:
    """A random torchvision-named (pytorch_fid) state_dict from `seed`,
    for `.pth` files in tests and smoke runs: conv.weight and bn.{weight,
    bias, running_mean, running_var} per unit.

    The BatchNorm statistics are those of each unit's conv output on a
    seeded batch of `n_images` 299² noise images, taken unit by unit in
    one forward, so every unit's input to its ReLU has about mean bn.bias
    and std bn.weight there. The pool features then depend on the image
    (noise over a ninth of a noise image moves them by ~0.3 relative L2;
    with statistics drawn at random, by ~1e-4), which is what a hold of
    activations between two devices needs.

    Inputs unlike that batch (512² images through the antialiased resize,
    smooth fills) drive the last units far higher, to pool features of
    ~30, where FID's `sqrtm` of a rank-deficient covariance product keeps
    imaginary parts beyond pytorch_fid's 1e-3 check. So the last block's
    units are then scaled, bn.weight and bn.bias alike, so that 512² noise
    gives features of mean `_SEEDED_FEATURE_MEAN`, the scale of real
    Inception features. ReLU is positively homogeneous: the features scale
    exactly, and every relative distance between them stays as it was."""
    gen = torch.Generator().manual_seed(seed)
    model = InceptionV3()
    names = {u: path for path, u in model.units().items()}
    sd = {}
    for u, path in names.items():
        oc = u.weight.shape[0]
        u.weight.copy_(torch.randn(u.weight.shape, generator=gen)
                       / math.sqrt(u.weight[0].numel()))
        sd[f"{path}.conv.weight"] = u.weight.detach().clone()
        sd[f"{path}.bn.weight"] = 0.5 + torch.rand(oc, generator=gen)
        sd[f"{path}.bn.bias"] = 0.1 * torch.randn(oc, generator=gen)

    def calibrate(unit, inputs, _):
        path = names[unit]
        y = F.conv2d(inputs[0], unit.weight, stride=unit.stride,
                     padding=unit.padding)
        mean, var = y.mean(dim=(0, 2, 3)), y.var(dim=(0, 2, 3))
        sd[f"{path}.bn.running_mean"] = mean
        sd[f"{path}.bn.running_var"] = var
        scale = sd[f"{path}.bn.weight"] / torch.sqrt(var + _BN_EPS)
        bias = sd[f"{path}.bn.bias"] - mean * scale
        return F.relu(y * scale[:, None, None] + bias[:, None, None])

    hooks = [u.register_forward_hook(calibrate) for u in names]
    try:
        inception_apply(model, torch.rand(n_images, 299, 299, 3,
                                          generator=gen), resize_input=False)
    finally:
        for h in hooks:
            h.remove()

    feats = inception_apply(import_inception_state_dict(sd), torch.rand(
        n_images, 512, 512, 3, generator=gen))
    k = _SEEDED_FEATURE_MEAN / feats.mean()
    for name in _LAST_UNITS:
        for p in ("weight", "bias"):
            sd[f"Mixed_7c.{name}.bn.{p}"] = sd[f"Mixed_7c.{name}.bn.{p}"] * k
    return sd
