"""`migan_tpu_torch` never imports JAX or any module of `migan_tpu`: a
fresh interpreter imports every module of the package, runs a tiny forward
through the kernel chain and the demo's file readers and writer on a PNG,
and finds neither in sys.modules. `chip_smoke.py` names neither in any of
its imports."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile
import migan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(migan_tpu_torch.__path__,
                                                "migan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import numpy as np
import torch
from PIL import Image
from migan_tpu_torch.cli import demo
from migan_tpu_torch.models.migan_inference import (
    GeneratorConfig, generator_init)
from migan_tpu_torch.models.migan_kernels import KernelGenerator
g = generator_init(GeneratorConfig(resolution=32, ch_base=512),
                   torch.Generator().manual_seed(0))
assert KernelGenerator(g)(torch.zeros(1, 32, 32, 4)).shape == (1, 32, 32, 3)
with tempfile.TemporaryDirectory() as d:
    rng = np.random.RandomState(0)
    Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8)).save(
        f"{d}/a.png")
    Image.fromarray(np.where(rng.rand(40, 48) > .5, 255, 0).astype(
        np.uint8)).save(f"{d}/m.png")
    img, mask, x = demo._load_input(f"{d}/a.png", d, 32, False)
    assert x.shape == (1, 32, 32, 4)
    demo._save(np.zeros((32, 32, 3), np.float32), f"{d}/a.png", img, mask, d)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "migan_tpu" or m.startswith("migan_tpu."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 17 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_imports_neither_jax_nor_migan_tpu():
    """chip_smoke imports lazily, inside its phases: every import statement
    in the file, at any depth, names only the port, torch or the standard
    library."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert "migan_tpu_torch.cli.demo" in mods
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "migan_tpu")]
