"""What a run needs, found by name: the cell in `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`) and the code of the mix's kind
(`traffic/<kind>.py`), its correctness limits (`workloads/<cell>.json`)
and the reader of each per-layer metric (`metrics/<name>.py`, or the
file of the longest dot-separated prefix of the name). A new cell,
configuration, mix or metric is new files and new entries, never an
edit.

A kind module has `setup(run)`, `measure(run, state)`,
`release(run, state)`, `verify(run, state, window)` and, for the
calibration, `control(run, state, window)`; see `traffic/closed_loop.py`.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "migan_tpu")


@dataclass
class Run:
    """One run of one cell: its specs, its arguments, and a scratch
    directory under TMPDIR that `close` removes."""

    root: Path
    cell: dict
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    e2e: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    tmp: Optional[Path] = None
    # tests only: wraps the program's forward to break the timed path
    wrap: Optional[Callable] = None

    def scratch(self) -> Path:
        if self.tmp is None:
            self.tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
        return self.tmp

    def close(self) -> None:
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _for_cell(entries: List[dict], cell: str) -> List[dict]:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_run(workload: str, seed: int, seconds: float, trace: bool,
             root: Optional[Path] = None, device: str = "cuda") -> Run:
    root = Path(root or HERE.parent)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    mix = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = _json(HERE / "workloads" / f"{workload}.json")
    return Run(root, cell, config, mix, limits, seed, seconds, trace,
               device, _for_cell(bench["end_to_end"], workload),
               _for_cell(bench["per_layer"], workload))


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str) -> ModuleType:
    """traffic/<name>.py, the code of a traffic kind."""
    return importlib.import_module(f"portbench.traffic.{name}")


def reader(metric: str) -> ModuleType:
    """metrics/<name>.py, else the file of the name's longest prefix
    that ends at a dot (`device.idle_pct.batch` -> `device.idle_pct`)."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return _load(path, "portbench_metric_" + path.stem.replace(
                ".", "_"))
    raise SystemExit(f"no reader for the metric {metric!r} in metrics/")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not
    load, compared whole (`migan_tpu_torch` is not `migan_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"

