"""YAML config banks with macro resolution + CLI override layer: the
port's own copy of `migan_tpu/utils/config.py` (Python and PyYAML only).

Re-implements the capability of the reference config system
(reference: lib/cfg_helper.py:21-380, lib/cfg_holder.py:18-32):

  - macros inside YAML values: ``SAME(a.b.c)`` (absolute reference into the
    same tree), ``SEARCH(x.y)`` (depth-first search reference),
    ``MODEL(name)`` / ``DATASET(name)`` (pull from the model/dataset banks).
  - three banks: model (configs/model/*.yaml), dataset (configs/dataset/),
    experiment (configs/experiment/<name>.yaml — resolved twice so SEARCH
    can see MODEL/DATASET expansions).
  - ``super_cfg`` inheritance; model-bank ``args`` are *merged* not replaced,
    with ``delete_args`` support (cfg_helper.py:125-144); dataset-bank plain
    update with ``delete``.
  - debug-mode shrink and the global/per-device batch split
    (cfg_helper.py:238-266,440-463).
  - a global config holder singleton (cfg_holder.py).
"""

from __future__ import annotations

import copy
import os.path as osp
import time
from typing import Any, Dict, Optional

import yaml


def _index(tree, path_parts):
    zoom = tree
    for pi in path_parts:
        try:
            pi = int(pi)
        except ValueError:
            pass
        zoom = zoom[pi]
    return zoom


def cfg_solvef(cmd, root, banks: "ConfigBanks"):
    if not isinstance(cmd, str):
        return cmd
    if cmd.startswith("SAME"):
        p = [pi.strip() for pi in cmd[len("SAME"):].strip("()").split(".")]
        try:
            return cfg_solvef(_index(root, p), root, banks)
        except (KeyError, IndexError, TypeError):
            return cmd
    if cmd.startswith("SEARCH"):
        p = [pi.strip() for pi in cmd[len("SEARCH"):].strip("()").split(".")]
        try:
            return cfg_solvef(_index(root, p), root, banks)
        except (KeyError, IndexError, TypeError):
            pass
        # depth-first search into subtrees
        children = (root.values() if isinstance(root, dict)
                    else root if isinstance(root, list) else [])
        for child in children:
            if isinstance(child, (dict, list)):
                rv = cfg_solvef(cmd, child, banks)
                if rv != cmd:
                    return rv
        return cmd
    if cmd.startswith("MODEL"):
        return banks.model(cmd[len("MODEL"):].strip("()"))
    if cmd.startswith("DATASET"):
        return banks.dataset(cmd[len("DATASET"):].strip("()"))
    return cmd


def cfg_solve(cfg, cfg_root, banks: "ConfigBanks"):
    it = (range(len(cfg)) if isinstance(cfg, list)
          else list(cfg.keys()) if isinstance(cfg, dict) else [])
    for k in it:
        if isinstance(cfg[k], (list, dict)):
            cfg[k] = cfg_solve(cfg[k], cfg_root, banks)
        else:
            cfg[k] = cfg_solvef(cfg[k], cfg_root, banks)
    return cfg


class ConfigBanks:
    """model / dataset / experiment YAML banks."""

    def __init__(self, config_root: str = "configs"):
        self.config_root = config_root
        self._model_cache: Dict[str, Dict] = {}
        self._dataset_cache: Dict[str, Dict] = {}
        self._model_files: Dict[str, Dict] = {}
        self._dataset_files: Dict[str, Dict] = {}

    # -- file routing (reference cfg_helper.py:146-151,192-202) ----------
    def _model_yaml(self, name):
        for prefix in ("migan", "comodgan", "stylegan"):
            if name.startswith(prefix):
                return osp.join(self.config_root, "model", f"{prefix}.yaml")
        raise ValueError(f"no model yaml for {name}")

    def _dataset_yaml(self, name):
        for prefix in ("places2", "ffhq", "celeba"):
            if name.startswith(prefix):
                return osp.join(self.config_root, "dataset",
                                f"{prefix}.yaml")
        raise ValueError(f"no dataset yaml for {name}")

    def _load_file(self, path, cache):
        if path not in cache:
            with open(path) as f:
                cache[path] = yaml.safe_load(f)
        return cache[path]

    # -- banks ------------------------------------------------------------
    def model(self, name: str) -> Dict[str, Any]:
        if name in self._model_cache:
            return copy.deepcopy(self._model_cache[name])
        bank = self._load_file(self._model_yaml(name), self._model_files)
        cfg = copy.deepcopy(bank[name])
        cfg["name"] = name
        if "super_cfg" in cfg:
            super_cfg = self.model(cfg.pop("super_cfg"))
            if "args" in cfg:
                super_cfg.setdefault("args", {}).update(cfg.pop("args"))
            super_cfg.update(cfg)
            cfg = super_cfg
            for dargs in cfg.pop("delete_args", []):
                cfg["args"].pop(dargs, None)
        cfg = cfg_solve(cfg, cfg, self)
        self._model_cache[name] = cfg
        return copy.deepcopy(cfg)

    def dataset(self, name: str) -> Dict[str, Any]:
        if name in self._dataset_cache:
            return copy.deepcopy(self._dataset_cache[name])
        bank = self._load_file(self._dataset_yaml(name), self._dataset_files)
        cfg = copy.deepcopy(bank[name])
        cfg["name"] = name
        if cfg.get("super_cfg"):
            super_cfg = self.dataset(cfg.pop("super_cfg"))
            super_cfg.update(cfg)
            cfg = super_cfg
            cfg["super_cfg"] = None
            for d in cfg.pop("delete", []):
                cfg.pop(d, None)
        cfg = cfg_solve(cfg, cfg, self)
        self._dataset_cache[name] = cfg
        return copy.deepcopy(cfg)

    def experiment(self, name: str) -> Dict[str, Any]:
        path = osp.join(self.config_root, "experiment", f"{name}.yaml")
        with open(path) as f:
            cfg = yaml.safe_load(f)
        cfg = cfg_solve(cfg, cfg, self)
        cfg = cfg_solve(cfg, cfg, self)  # twice for SEARCH over expansions
        return cfg


def get_experiment_id() -> int:
    """reference cfg_helper.py:233-235."""
    time.sleep(0.01)
    return int(time.time() * 100)


def cfg_to_debug(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Shrink for debug runs (reference cfg_helper.py:238-266)."""
    if "train" in cfg:
        t = cfg["train"]
        t["experiment_id"] = 999999999999
        t["signature"] = []
        t["batch_size"] = None
        t["batch_size_per_device"] = 2
        t["dataset_num_workers"] = 2
    return cfg


def split_batch(cfg_section: Dict[str, Any], device_count: int) -> None:
    """Global <-> per-device batch/worker splitting
    (reference cfg_helper.py:440-463); the single-device trainer passes
    device_count = 1."""
    bs, bspd = (cfg_section.get("batch_size"),
                cfg_section.get("batch_size_per_device")
                or cfg_section.get("batch_size_per_gpu"))
    if bs is None and bspd is None:
        raise ValueError("need batch_size or batch_size_per_device")
    if bs is not None and bspd is not None and bs != bspd * device_count:
        raise ValueError(f"batch_size {bs} != per_device {bspd} x "
                         f"{device_count}")
    if bs is None:
        cfg_section["batch_size"] = bspd * device_count
    if bspd is None:
        if bs % device_count:
            raise ValueError(f"batch_size {bs} not divisible by "
                             f"{device_count} devices")
        cfg_section["batch_size_per_device"] = bs // device_count


def apply_overrides(cfg: Dict[str, Any], assignments) -> Dict[str, Any]:
    """Arbitrary-key CLI overrides: ``--set a.b.c=value`` (repeatable).

    Generalizes the reference's fixed-flag override layer
    (reference lib/cfg_helper.py:269-380) to any config path. Values are
    YAML-parsed (``1e-4`` -> float, ``[0,0.99]`` -> list, ``null`` -> None);
    integer path segments index lists; missing intermediate dicts are
    created.
    """
    for a in assignments or []:
        path, sep, raw = a.partition("=")
        if not sep:
            raise ValueError(f"override {a!r} must look like path.to.key=value")
        val = yaml.safe_load(raw) if raw != "" else None
        if isinstance(val, str):
            # YAML 1.1 won't parse '1e-4' as a float (needs '1.0e-4');
            # fall back to Python numeric parsing for bare numbers.
            try:
                val = int(val)
            except ValueError:
                try:
                    val = float(val)
                except ValueError:
                    pass
        parts = [p.strip() for p in path.strip().split(".") if p.strip()]
        if not parts:
            raise ValueError(f"override {a!r} has an empty path")
        node = cfg
        for p in parts[:-1]:
            if isinstance(node, list):
                node = node[int(p)]
            else:
                node = node.setdefault(p, {})
        last = parts[-1]
        if isinstance(node, list):
            node[int(last)] = val
        else:
            node[last] = val
    return cfg


class cfg_unique_holder:
    """Global config singleton (reference lib/cfg_holder.py:18-32)."""

    _instance: Optional["cfg_unique_holder"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.cfg = None
        return cls._instance

    def save_cfg(self, cfg):
        self.cfg = copy.deepcopy(cfg)
