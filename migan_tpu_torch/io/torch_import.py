"""Read a PyTorch `.pt`/`.pth` state_dict file as numpy arrays (port of
`migan_tpu/io/torch_import.py::load_torch_state_dict`): the detectors'
importers (`evalx/inception.py`, `evalx/lpips.py`) fold and lay out the
weights in numpy, as the JAX package does."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A state_dict (or a module whose `state_dict()` it is) on the CPU,
    as numpy arrays. Loads tensors only (`weights_only=True`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}
