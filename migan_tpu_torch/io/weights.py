"""Weight bridge: the JAX package's `.npz` files and the reference's `.pt`
state_dicts to a `Generator` module, and back to `.npz`.

- `.npz` (`migan_tpu/io/checkpoint.py`): flat `/`-joined pytree paths,
  conv weights HWIO. Read and written with numpy alone; weights become
  torch's OIHW (depthwise [3,3,1,C] -> [C,1,3,3], pointwise [1,1,C,O] ->
  [O,C,1,1]).
- `.pt`: a reference `migan_inference.Generator` state_dict (key map of
  `migan_tpu/io/torch_import.py:46-104`). Its keys already follow the
  module tree and its weights are OIHW; the fixed resampling buffers
  (`*.filter.*`, `*.filter_const`) are dropped, since the port computes
  resampling. `export_migan_inference` is the way back.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..models.migan_inference import Generator, GeneratorConfig


def _infer_config(keys) -> GeneratorConfig:
    levels = [int(m.group(1)) for k in keys
              if (m := re.match(r"encoder[./]b(\d+)[./]", k))]
    if not levels:
        raise ValueError("no encoder.b<res> weights found")
    return GeneratorConfig(resolution=max(levels))


def _from_state(state: Mapping[str, torch.Tensor],
                cfg: Optional[GeneratorConfig]) -> Generator:
    g = Generator(cfg or _infer_config(state.keys()))
    g.load_state_dict(dict(state), strict=True)
    return g


def load_npz(path: str, cfg: Optional[GeneratorConfig] = None) -> Generator:
    """Read a `migan_tpu` `.npz` into a float32 `Generator` on the CPU.
    cfg defaults to the standard config of the weights' resolution."""
    state = {}
    with np.load(path) as data:
        for key in data.files:
            v = np.asarray(data[key], np.float32)
            if v.ndim == 4:                       # HWIO -> OIHW
                v = v.transpose(3, 2, 0, 1)
            state[key.replace("/", ".")] = torch.from_numpy(
                np.ascontiguousarray(v))
    return _from_state(state, cfg)


def save_npz(path: str, generator: Generator) -> None:
    """Write the generator in the `migan_tpu` `.npz` format (HWIO)."""
    flat = {}
    for key, v in generator.state_dict().items():
        v = v.detach().to("cpu", torch.float32).numpy()
        if v.ndim == 4:                           # OIHW -> HWIO
            v = v.transpose(2, 3, 1, 0)
        # np.array keeps a 0-d noise_strength 0-d (ascontiguousarray
        # would make it [1])
        flat[key.replace(".", "/")] = np.array(v, order="C")
    np.savez(path, **flat)


def load_pt(state_dict: Mapping[str, torch.Tensor],
            cfg: Optional[GeneratorConfig] = None) -> Generator:
    """A reference state_dict (as `torch.load(path, weights_only=True)`
    returns it) -> float32 `Generator` on the CPU."""
    state = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        if "filter" in parts or parts[-1] == "filter_const":
            continue
        if parts[-1] not in ("weight", "bias", "noise_const",
                             "noise_strength"):
            raise ValueError(f"unrecognized checkpoint key: {key}")
        state[key] = torch.as_tensor(val).detach().to("cpu", torch.float32)
    return _from_state(state, cfg)


def export_migan_inference(generator: Generator) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`load_pt` (the port's counterpart of
    `migan_tpu/io/torch_import.py::export_migan_inference`): the learnable
    subset of a reference `migan_inference.Generator` state_dict, float32
    on the CPU, conv weights OIHW. The reference module's fixed resampling
    buffers are not in it, as `load_pt` drops them; `torch.save` of the
    dict is a `.pt` that `load_weights` reads."""
    return {k: v.detach().to("cpu", torch.float32).clone()
            for k, v in generator.state_dict().items()}


def load_weights(path: str, cfg: Optional[GeneratorConfig] = None
                 ) -> Generator:
    """`.npz` through :func:`load_npz`, anything else as a `.pt`
    state_dict through :func:`load_pt`."""
    if path.endswith(".npz"):
        return load_npz(path, cfg)
    return load_pt(torch.load(path, map_location="cpu", weights_only=True),
                   cfg)
