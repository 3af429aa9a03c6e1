"""Weight bridge between the JAX package's files and the port's modules."""

from .weights import load_npz, load_pt, load_weights, save_npz

__all__ = ["load_npz", "load_pt", "load_weights", "save_npz"]
