"""Weight bridge of the training networks (`models/migan.py`) and of the
Co-Mod-GAN teacher and StyleGAN2 nets (`models/comodgan.py`,
`models/stylegan.py`).

- The JAX package's params `.npz` (`migan_tpu/io/checkpoint.py`): flat
  `/`-joined pytree paths, conv weights HWIO, re-param stacks `w_stack`
  [N, kh, kw, I/g, O], dense weights [out, in], the StyleGAN synthesis
  `const` [res, res, C], `noise_const`, `noise_strength` and the
  mapping's `w_avg` as they are. Read and written with numpy alone.
- Reference training state_dicts (`migan_tpu/io/torch_import.py:104-173`):
  OIHW weights, the re-param tensors as `w0..wN-1`, `const` [C, res, res],
  `w_avg`, and `resample_filter` buffers, which are dropped (the port
  computes its filters).
- The port's modules: OIHW weights, `w_stack` [N, O, I/g, kh, kw],
  `const` [C, res, res], keys the JAX paths joined by dots.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..models.migan import Generator, MiganConfig

_LEAVES = ("weight", "bias", "noise_const", "noise_strength", "const",
           "w_avg")


def _leaf(key: str) -> str:
    return re.split(r"[./]", key)[-1]


def _to_torch_layout(key: str, v: np.ndarray) -> np.ndarray:
    if key.endswith("w_stack"):                  # [N,kh,kw,I,O] -> [N,O,I,kh,kw]
        return v.transpose(0, 4, 3, 1, 2)
    if v.ndim == 4:                              # HWIO -> OIHW
        return v.transpose(3, 2, 0, 1)
    if _leaf(key) == "const":                    # HWC -> CHW
        return v.transpose(2, 0, 1)
    return v


def _to_jax_layout(key: str, v: np.ndarray) -> np.ndarray:
    if key.endswith("w_stack"):
        return v.transpose(0, 3, 4, 2, 1)
    if v.ndim == 4:
        return v.transpose(2, 3, 1, 0)
    if _leaf(key) == "const":
        return v.transpose(1, 2, 0)
    return v


def params_to_state(flat: Mapping[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """Flat JAX params (`/`-joined paths; the training nets, Co-Mod-GAN or
    the StyleGAN2 nets) -> the port's float32 state_dict."""
    # np.array, not ascontiguousarray, which makes a 0-d array 1-d
    return {k.replace("/", "."): torch.from_numpy(np.array(
        _to_torch_layout(k, np.asarray(v, np.float32)), order="C"))
        for k, v in flat.items()}


def state_to_params(state: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_to_state`."""
    return {k.replace(".", "/"): np.array(_to_jax_layout(
        k, v.detach().to("cpu", torch.float32).numpy()), order="C")
        for k, v in state.items()}


def load_train_npz(path: str) -> Dict[str, torch.Tensor]:
    """A JAX training-params `.npz` as the port's state_dict."""
    with np.load(path) as data:
        return params_to_state({k: data[k] for k in data.files})


def save_train_npz(path: str, module: torch.nn.Module) -> None:
    """Write a training net, or a Co-Mod-GAN / StyleGAN2 net, in the JAX
    package's params `.npz`."""
    np.savez(path, **state_to_params(module.state_dict()))


def import_migan_train(state_dict: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    """A reference state_dict (the training G or D, Co-Mod-GAN, StyleGAN2;
    numpy or torch values) -> the port's state_dict: `w0..wN-1` stacked
    into `w_stack`, `resample_filter` buffers dropped; `const` keeps the
    reference's [C, res, res], the port's layout."""
    reparam: Dict[str, list] = {}
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        leaf = parts[-1]
        if leaf == "resample_filter":
            continue
        val = torch.from_numpy(np.array(val, np.float32))
        m = re.fullmatch(r"w(\d+)", leaf)
        if m is not None:
            reparam.setdefault(".".join(parts[:-1]), []).append(
                (int(m.group(1)), val))
        elif leaf in _LEAVES:
            out[key] = val
        else:
            raise ValueError(f"unrecognized checkpoint key: {key}")
    for prefix, tensors in reparam.items():
        tensors.sort(key=lambda t: t[0])
        out[f"{prefix}.w_stack"] = torch.stack([v for _, v in tensors])
    return out


def export_migan_train(state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_migan_train` (minus the dropped buffers):
    the port's state_dict -> a reference-style state_dict of numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    for key, v in state.items():
        v = v.detach().to("cpu", torch.float32).numpy()
        if key.endswith("w_stack"):
            base = key[: -len("w_stack")]
            for i in range(v.shape[0]):
                out[f"{base}w{i}"] = v[i]
        else:
            out[key] = v
    return out


def load_train_state(path: str) -> Dict[str, torch.Tensor]:
    """The port's float32 state_dict of a training net, Co-Mod-GAN or
    StyleGAN2 net from the JAX package's `.npz`, a reference `.pt`/`.pth`
    state_dict, or a reference `network-snapshot-*.pkl` (its `G_ema`, else
    its `G`)."""
    if path.endswith(".npz"):
        return load_train_npz(path)
    if path.endswith(".pkl"):
        from .pkl_import import load_reference_snapshot

        snap = load_reference_snapshot(path)
        sd: Optional[dict] = snap.get("G_ema") or snap.get("G")
        if sd is None:
            raise ValueError(f"{path}: no G_ema or G module in the snapshot")
        return import_migan_train(sd)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return import_migan_train({k: v.detach().numpy() for k, v in sd.items()})


def load_train_generator(path: str, cfg: MiganConfig) -> Generator:
    """A float32 training `Generator` on the CPU from any file of
    :func:`load_train_state`."""
    g = Generator(cfg)
    g.load_state_dict(load_train_state(path), strict=True)
    return g
