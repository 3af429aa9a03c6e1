"""Shared libraries built at first use, for the CUDA kernels
(`ops/kernels/_build.py`) and the host mask rasterizer
(`data/fast_masks.py`).

A library is named by a hash of its compiler command and its sources, so
a change of either builds a new one and an existing file is never stale.
Builds wait on a file lock in the build directory, so concurrent builders
(processes, loader threads) compile once, and the library appears
atomically under its final name.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import tempfile
from pathlib import Path
from typing import Callable, Sequence


def hashed_path(build_dir: Path, stem: str, command: Sequence[str],
                sources: Sequence[Path]) -> Path:
    """build_dir / lib{stem}_{hash}.so, the hash over the compiler command
    (compiler and flags) and each source's name and bytes."""
    h = hashlib.sha256("\0".join(command).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_once(out: Path, compile_into: Callable[[str], str]) -> Path:
    """Return `out`, first calling compile_into(tmpdir) -> path of the new
    library under the lock unless `out` exists; the library is then moved
    to `out`. Errors of compile_into propagate and leave no library."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():          # built while this one waited
            return out
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            os.replace(compile_into(tmp), out)
    return out
