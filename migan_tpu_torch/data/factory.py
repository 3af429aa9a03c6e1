"""Plug-in data factory: dataset, loader and formatter registries (the
port's own copy of `migan_tpu/data/factory.py`; reference lib/
data_factory/common/ds_base.py:11-129, ds_loader.py, ds_formatter.py).

A dataset is a list of load-info dicts, each run through a chain of
loaders, then a formatter. Items are numpy NHWC; the trainer moves each
batch to its device. `collate` lives in `data/sampler.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

_DATASETS: Dict[str, type] = {}
_LOADERS: Dict[str, type] = {}
_FORMATTERS: Dict[str, type] = {}


def regdataset(name: Optional[str] = None):
    def deco(cls):
        _DATASETS[name or cls.__name__] = cls
        return cls
    return deco


def regloader(name: Optional[str] = None):
    def deco(cls):
        _LOADERS[name or cls.__name__] = cls
        return cls
    return deco


def regformat(name: Optional[str] = None):
    def deco(cls):
        _FORMATTERS[name or cls.__name__] = cls
        return cls
    return deco


def get_dataset(cfg: Dict[str, Any]):
    """A dataset from its config dict (reference ds_base.py:62-90): `type`
    and the dataset's own args; `loader` a list of {type, args},
    `formatter` a {type, args}."""
    from . import ds_ffhq, ds_places2  # noqa: F401  (register classes)

    if cfg["type"] not in _DATASETS:
        raise ValueError(f"unknown dataset type {cfg['type']!r} (known: "
                         f"{sorted(_DATASETS)})")
    return _DATASETS[cfg["type"]](cfg)


class ds_base:
    """Dataset = load_info list + loader chain + formatter
    (reference ds_base.py:11-59)."""

    # formatters take an explicit per-item RNG (the DataLoader's seed
    # mode): masks, flips and crops are then the same at any worker count
    supports_rng = True

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg
        self.init_load_info(cfg)
        self.loaders = [_LOADERS[lcfg["type"]](**lcfg.get("args") or {})
                        for lcfg in cfg.get("loader") or []]
        fcfg = cfg.get("formatter")
        self.formatter = (_FORMATTERS[fcfg["type"]](**fcfg.get("args") or {})
                          if fcfg else None)
        # cache_decoded: keep each decoded element in host memory, and let
        # formatters memoize deterministic derived arrays (the bicubic
        # resize) into it. Costs one decoded copy of the dataset; random
        # draws (flips, masks, crops) stay per access.
        self._cache: Optional[Dict[int, Dict[str, Any]]] = (
            {} if cfg.get("cache_decoded") else None)

    def init_load_info(self, cfg):
        raise NotImplementedError

    def __len__(self):
        return len(self.load_info)

    def __getitem__(self, idx, rng=None):
        if self._cache is not None:
            element = self._cache.get(idx)
            if element is None:
                element = dict(self.load_info[idx])
                for loader in self.loaders:
                    loader(element)
                element["_cache_derived"] = True
                # a dict store is atomic under the GIL; a racing worker at
                # worst decodes the same item twice
                self._cache[idx] = element
        else:
            element = dict(self.load_info[idx])
            for loader in self.loaders:
                loader(element)
        if self.formatter is not None:
            if rng is not None:
                return self.formatter(element, rng=rng)
            return self.formatter(element)
        return element
