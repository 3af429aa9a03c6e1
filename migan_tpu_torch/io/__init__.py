"""Weight bridge between the JAX package's files, the reference's
checkpoints and the port's modules, and the state_dict reader of the
detectors."""

from .pkl_import import load_reference_snapshot, loads_reference_snapshot
from .torch_import import load_torch_state_dict
from .train_weights import (
    export_migan_train, import_migan_train, load_train_generator,
    load_train_npz, load_train_state, save_train_npz,
)
from .weights import (export_migan_inference, load_npz, load_pt,
                      load_weights, save_npz)

__all__ = ["export_migan_inference", "export_migan_train",
           "import_migan_train",
           "load_reference_snapshot", "loads_reference_snapshot", "load_npz",
           "load_pt", "load_torch_state_dict", "load_train_generator",
           "load_train_npz", "load_train_state", "load_weights", "save_npz",
           "save_train_npz"]
