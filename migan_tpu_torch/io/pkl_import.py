"""Load reference training snapshots (``network-snapshot-*.pkl``); the
port's own copy of `migan_tpu/io/pkl_import.py`.

The reference checkpoints its training state as a plain pickle of whole
torch modules ``{'G': nn.Module, 'D': ..., 'G_ema': ...}``
(reference: lib/experiments/migan_default.py:538-551), and its export
script consumes exactly that file (reference:
scripts/export_inference_model.py:116-124). Unpickling such a file
normally requires the reference's own class definitions importable at
their original module paths (``lib.model_zoo...``).

This loader removes that requirement: any class outside a small
allowlist (torch, numpy, stdlib containers) is substituted with an inert
stub, and the resulting object tree is walked through torch's module
attributes (``_parameters`` / ``_buffers`` / ``_modules``) to recover
flat state_dicts. Published snapshots therefore import with only torch
installed — no reference code on sys.path, and none of the pickled
classes' code ever executes.

StyleGAN-ADA "persistence" pickles (classes wrapped by
``torch_utils.persistence``, used by older published .pkl models — see
reference torch_utils/persistence.py:35 and lib/model_zoo/
simpleinpainting.py:1-2) are handled the same way: their
``_reconstruct_persistent_obj(meta)`` hook is intercepted and the
embedded ``meta.state`` is applied to a stub instead of executing the
embedded source code.
"""

from __future__ import annotations

import io as _io
import pickle
from typing import Any, Dict, Optional

import numpy as np

# Modules whose classes/functions are resolved normally. Everything else
# is stubbed. torch is required for tensor/storage reconstruction.
_SAFE_PREFIXES = (
    "torch",
    "numpy",
    "collections",
    "builtins",
    "copyreg",
    "_codecs",
)


class _StubBase(dict):
    """Inert stand-in for an unavailable pickled class.

    Subclasses ``dict`` so dict-subclass pickles (e.g. the reference's
    ``dnnlib.EasyDict``) restore their items; attribute state is applied
    via ``__setstate__`` like a normal object.
    """

    def __init__(self, *args, **kwargs):  # tolerate any ctor protocol
        super().__init__()

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:
            state, slots = state
            if slots:
                self.__dict__.update(slots)
        if isinstance(state, dict):
            self.__dict__.update(state)

    # Old-style reduce protocols may append to list-like objects.
    def append(self, item):
        self.setdefault("_appended", []).append(item)

    def extend(self, items):
        for it in items:
            self.append(it)


def _reconstruct_persistent_stub(meta):
    """Replacement for torch_utils.persistence._reconstruct_persistent_obj:
    apply the embedded state to a stub without executing ``module_src``."""
    cls_name = "PersistentStub"
    if isinstance(meta, dict):
        cls_name = str(
            meta.get("class_name")
            or getattr(meta, "__dict__", {}).get("class_name")
            or cls_name
        )
    obj = _make_stub("persistent", cls_name)()
    state = meta.get("state") if isinstance(meta, dict) else None
    if state is not None:
        obj.__setstate__(state)
    return obj


_stub_cache: Dict[tuple, type] = {}


def _make_stub(module: str, name: str) -> type:
    key = (module, name)
    cls = _stub_cache.get(key)
    if cls is None:
        cls = type(name, (_StubBase,), {"__module__": module})
        _stub_cache[key] = cls
    return cls


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if name == "_reconstruct_persistent_obj":
            return _reconstruct_persistent_stub
        root = module.split(".", 1)[0]
        if root in _SAFE_PREFIXES:
            return super().find_class(module, name)
        return _make_stub(module, name)


def _tensor_to_numpy(t) -> Optional[np.ndarray]:
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return None


def module_state_dict(mod: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Recover a flat ``state_dict`` (numpy values) from a stubbed torch
    module tree by walking ``_parameters`` / ``_buffers`` / ``_modules`` —
    the attributes torch modules carry in their ``__dict__`` regardless of
    whether their class code is importable."""
    out: Dict[str, np.ndarray] = {}
    d = getattr(mod, "__dict__", None)
    if not isinstance(d, dict):
        return out
    for group in ("_parameters", "_buffers"):
        for name, t in (d.get(group) or {}).items():
            arr = _tensor_to_numpy(t)
            if arr is not None:
                out[prefix + name] = arr
    for name, sub in (d.get("_modules") or {}).items():
        if sub is not None:
            out.update(module_state_dict(sub, f"{prefix}{name}."))
    return out


def load_reference_snapshot(
    path: str,
) -> Dict[str, Optional[Dict[str, np.ndarray]]]:
    """Load a reference ``network-snapshot-*.pkl`` into state_dicts.

    Returns ``{'G': state_dict, 'D': state_dict, 'G_ema': state_dict}``
    (entries the snapshot lacks, or stored as None, map to None). Also
    accepts a pickle of a single bare module, returned under key ``'G'``.
    """
    with open(path, "rb") as f:
        return loads_reference_snapshot(f.read())


def loads_reference_snapshot(
    blob: bytes,
) -> Dict[str, Optional[Dict[str, np.ndarray]]]:
    """:func:`load_reference_snapshot` over an in-memory pickle blob."""
    data = _StubUnpickler(_io.BytesIO(blob)).load()
    # A stubbed bare module is itself a dict subclass; the snapshot dict
    # is a plain dict and has no ``_modules`` in its instance __dict__.
    if not isinstance(data, dict) or "_modules" in getattr(
        data, "__dict__", {}
    ):
        return {"G": module_state_dict(data) or None}
    return {
        str(name): (module_state_dict(mod) or None)
        if mod is not None else None
        for name, mod in data.items()
    }
