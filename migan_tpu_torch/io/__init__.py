"""Weight bridge between the JAX package's files and the port's modules,
and the state_dict reader of the detectors."""

from .torch_import import load_torch_state_dict
from .weights import load_npz, load_pt, load_weights, save_npz

__all__ = ["load_npz", "load_pt", "load_torch_state_dict", "load_weights",
           "save_npz"]
