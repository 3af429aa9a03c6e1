"""InceptionV3 feature extractor for FID in both of the reference's
flavors (port of `migan_tpu/evalx/inception.py`), NHWC in, [N, 2048]
pool features out. The two flavors share the backbone (pytorch_fid's
FIDInception* classes are a port of the TF graph NVIDIA's detector is
translated from) and differ in input contract, resize and weight names:

- pytorch_fid, the standalone evaluation's detector (reference
  scripts/evaluate_fid_lpips.py:216-218), `inception_apply`: input in
  [0, 1], resized to 299 x 299 bilinear, scaled to [-1, 1]. The resize is
  the JAX package's, `jax.image.resize(..., "bilinear")`, which
  antialiases when it shrinks (`ops/resize.py`); at a 512 input this is
  not what pytorch_fid computes (it does not antialias), but the port is
  held against the JAX package. Torchvision weight names.
- nvidia_tf, the training-time detector (reference
  frechet_inception_distance.py:25-29, NVIDIA's TorchScript translation
  of the TF inception-2015-12-05 graph), `inception_apply_nvidia`: input
  in [0, 255], TF1's legacy bilinear resize to 299 (`tf_resize_bilinear`),
  then (x - 128) / 128. TF tower weight names
  (`import_inception_tf_names`).

The FID variant of InceptionV3 (avg-pool branches with
count_include_pad=False, a max-pool branch in Mixed_7c). BatchNorm is
folded into a per-channel scale and bias at import: each unit is conv (no
bias), x * scale + bias, ReLU. Plain PyTorch on cuDNN: the JAX package
runs this in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
import zipfile
from typing import Callable, Dict, Mapping, Optional, Tuple

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


def tf_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int
                       ) -> torch.Tensor:
    """TF1's legacy ``resize_bilinear(align_corners=False)``, NHWC: source
    coordinate dst * (in / out) with no half-pixel offset, neighbours
    clamped to the border (the resize baked into NVIDIA's TorchScript
    detector by its affine_grid / grid_sample). Neither `F.interpolate`
    mode computes it; this is the JAX package's separable gather and
    lerp, in x's dtype."""

    def axis(in_size, out_size):
        src = torch.arange(out_size, dtype=x.dtype, device=x.device) * (
            in_size / out_size)
        i0 = torch.floor(src)
        frac = src - i0
        i0 = i0.long().clamp(0, in_size - 1)
        return i0, (i0 + 1).clamp(max=in_size - 1), frac

    _, h, w, _ = x.shape
    if h != out_h:
        i0, i1, f = axis(h, out_h)
        f = f[None, :, None, None]
        x = x[:, i0] * (1 - f) + x[:, i1] * f
    if w != out_w:
        j0, j1, f = axis(w, out_w)
        f = f[None, None, :, None]
        x = x[:, :, j0] * (1 - f) + x[:, :, j1] * f
    return x


@torch.no_grad()
def inception_apply_nvidia(model: InceptionV3, x: torch.Tensor
                           ) -> torch.Tensor:
    """The training-time detector's contract: x NHWC float (or uint8) in
    [0, 255] -> [N, 2048] pool features (float32)."""
    x = tf_resize_bilinear(x.to(torch.float32), 299, 299)
    return model((x - 128.0) / 128.0)


def make_detector(model: InceptionV3, flavor: str = "pytorch_fid"
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The metric stack's detector for either flavor: NHWC float in
    [0, 1] -> [N, 2048] features. nvidia_tf first quantizes to the uint8
    grid, floor(x * 255 + 0.5), as the reference casts composites to
    uint8 before its TorchScript detector (metric_utils.py:40-51), so that
    numbers match the reference's training logs."""
    if flavor == "pytorch_fid":
        return lambda x: inception_apply(model, x)
    if flavor == "nvidia_tf":
        return lambda x: inception_apply_nvidia(
            model, torch.floor(x.clamp(0.0, 1.0) * 255.0 + 0.5))
    raise ValueError(f"unknown detector flavor {flavor!r}")


# ---------------------------------------------------------------------------
# Weight import, random init
# ---------------------------------------------------------------------------

def _fold(f: Mapping[str, np.ndarray], unit: Unit, where: str) -> None:
    """Load conv + BatchNorm arrays into a folded unit (numpy float32
    arithmetic, as the JAX importers)."""
    missing = {"conv.weight", "bn.bias", "bn.running_mean",
               "bn.running_var"} - set(f)
    if missing:
        raise ValueError(f"{where}: no {sorted(missing)} in the state_dict")
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


# TF graph unit -> torchvision unit path. NVIDIA's detector keeps the TF
# graph's tower names; `_fold` checks each kernel's shape against the
# unit's, so a wrong orientation here fails on import.
_TF_BLOCKS = {"mixed": ("Mixed_5b", "A"), "mixed_1": ("Mixed_5c", "A"),
              "mixed_2": ("Mixed_5d", "A"), "mixed_3": ("Mixed_6a", "B"),
              "mixed_4": ("Mixed_6b", "C"), "mixed_5": ("Mixed_6c", "C"),
              "mixed_6": ("Mixed_6d", "C"), "mixed_7": ("Mixed_6e", "C"),
              "mixed_8": ("Mixed_7a", "D"), "mixed_9": ("Mixed_7b", "E"),
              "mixed_10": ("Mixed_7c", "E")}
_TF_BRANCHES = {
    "A": {"conv": "branch1x1", "tower.conv": "branch5x5_1",
          "tower.conv_1": "branch5x5_2", "tower_1.conv": "branch3x3dbl_1",
          "tower_1.conv_1": "branch3x3dbl_2",
          "tower_1.conv_2": "branch3x3dbl_3", "tower_2.conv": "branch_pool"},
    "B": {"conv": "branch3x3", "tower.conv": "branch3x3dbl_1",
          "tower.conv_1": "branch3x3dbl_2", "tower.conv_2": "branch3x3dbl_3"},
    "C": {"conv": "branch1x1", "tower.conv": "branch7x7_1",
          "tower.conv_1": "branch7x7_2", "tower.conv_2": "branch7x7_3",
          "tower_1.conv": "branch7x7dbl_1", "tower_1.conv_1": "branch7x7dbl_2",
          "tower_1.conv_2": "branch7x7dbl_3",
          "tower_1.conv_3": "branch7x7dbl_4",
          "tower_1.conv_4": "branch7x7dbl_5", "tower_2.conv": "branch_pool"},
    "D": {"tower.conv": "branch3x3_1", "tower.conv_1": "branch3x3_2",
          "tower_1.conv": "branch7x7x3_1", "tower_1.conv_1": "branch7x7x3_2",
          "tower_1.conv_2": "branch7x7x3_3",
          "tower_1.conv_3": "branch7x7x3_4"},
    "E": {"conv": "branch1x1", "tower.conv": "branch3x3_1",
          "tower.mixed.conv": "branch3x3_2a",
          "tower.mixed.conv_1": "branch3x3_2b",
          "tower_1.conv": "branch3x3dbl_1", "tower_1.conv_1": "branch3x3dbl_2",
          "tower_1.mixed.conv": "branch3x3dbl_3a",
          "tower_1.mixed.conv_1": "branch3x3dbl_3b",
          "tower_2.conv": "branch_pool"},
}
TF_UNITS = {"conv": "Conv2d_1a_3x3", "conv_1": "Conv2d_2a_3x3",
            "conv_2": "Conv2d_2b_3x3", "conv_3": "Conv2d_3b_1x1",
            "conv_4": "Conv2d_4a_3x3",
            **{f"{tf}.{sub}": f"{ours}.{branch}"
               for tf, (ours, kind) in _TF_BLOCKS.items()
               for sub, branch in _TF_BRANCHES[kind].items()}}


def import_inception_tf_names(sd: Mapping[str, np.ndarray]) -> InceptionV3:
    """NVIDIA's TorchScript detector's (TF-named) state_dict -> folded
    `InceptionV3`: keys like 'layers.mixed_4.tower.conv_1.conv.weight'
    and '...{bn,batchnorm}.{weight,bias,running_mean,running_var}' (the
    'layers.' prefix optional, as is the BatchNorm scale: the TF 2015
    graph's batchnorm has beta only). The classifier head ('output.*') is
    ignored: FID reads pool features."""
    units: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in sd.items():
        k = key[len("layers."):] if key.startswith("layers.") else key
        if k.startswith("output.") or "num_batches" in k:
            continue
        *unit, mod, leaf = k.split(".")
        if mod in ("bn", "batchnorm"):
            field = "bn." + leaf
        elif mod == "conv" and leaf == "weight" and np.ndim(val) == 4:
            field = "conv.weight"
        else:
            raise ValueError(f"unrecognized detector key layout: {key!r}")
        units.setdefault(".".join(unit), {})[field] = np.asarray(val)
    if set(units) != set(TF_UNITS):
        raise ValueError(f"state_dict units differ from the TF graph's: "
                         f"{sorted(set(units) ^ set(TF_UNITS))[:8]}")
    model = InceptionV3()
    mine = model.units()
    for tf_unit, f in units.items():
        _fold(f, mine[TF_UNITS[tf_unit]], tf_unit)
    return model


def _is_torchscript(path: str) -> bool:
    """A TorchScript archive: a zip with a `<name>/constants.pkl` entry."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") for n in z.namelist())


def _torchscript_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The state_dict of a TorchScript archive as numpy arrays; only the
    weights are read, the scripted forward never runs."""
    mod = torch.jit.load(path, map_location="cpu")
    return {k: v.detach().cpu().numpy() for k, v in mod.state_dict().items()}


def import_inception_torchscript(path: str) -> InceptionV3:
    """NVIDIA's TorchScript detector file (inception-2015-12-05.pt,
    reference metric_utils.py:40-51) -> folded `InceptionV3`."""
    return import_inception_tf_names(_torchscript_state_dict(path))


def load_inception_weights(path: str, flavor: str = "auto"
                           ) -> Tuple[InceptionV3, str]:
    """Detector weights from a file, and the FID flavor they are for
    ('pytorch_fid' or 'nvidia_tf'), told by their names: torchvision's
    ('Mixed_5b.branch1x1...') or the TF graph's ('[layers.]mixed_4.
    tower...', and every TorchScript archive's). The reference's two
    detectors give different FIDs, so a `flavor` other than 'auto' that
    the file does not hold raises ValueError."""
    from ..io.torch_import import load_torch_state_dict

    sd = (_torchscript_state_dict(path) if _is_torchscript(path)
          else load_torch_state_dict(path))
    keys = list(sd)
    has_torchvision = any(k.startswith(("Mixed_", "Conv2d_")) for k in keys)
    has_tf = any(
        (k[len("layers."):] if k.startswith("layers.") else k).startswith(
            ("mixed", "conv"))
        for k in keys if not k.startswith("output."))
    if has_torchvision == has_tf:
        raise ValueError(f"cannot detect the detector layout of {path} "
                         f"(keys like {keys[:3]})")
    detected = "nvidia_tf" if has_tf else "pytorch_fid"
    if flavor not in ("auto", detected):
        raise ValueError(f"requested flavor {flavor!r} but {path} holds a "
                         f"{detected!r}-layout state_dict")
    if detected == "nvidia_tf":
        return import_inception_tf_names(sd), detected
    return import_inception_state_dict(sd), detected


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
def seeded_state_dict(seed: int, n_images: int = 4,
                      flavor: str = "pytorch_fid"
                      ) -> Dict[str, torch.Tensor]:
    """A random state_dict from `seed`, for `.pth` files in tests and
    smoke runs: conv.weight and bn.{weight, bias, running_mean,
    running_var} per unit, under torchvision's names (flavor
    'pytorch_fid') or the TF graph's, as NVIDIA's detector names them
    ('nvidia_tf': 'layers.<tf unit>.{conv,bn}.*'), the same weights.

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
    if flavor == "pytorch_fid":
        return sd
    if flavor != "nvidia_tf":
        raise ValueError(f"unknown detector flavor {flavor!r}")
    to_tf = {ours: tf for tf, ours in TF_UNITS.items()}
    out = {}
    for key, v in sd.items():
        unit, mod, leaf = key.rsplit(".", 2)
        out[f"layers.{to_tf[unit]}.{mod}.{leaf}"] = v
    return out
