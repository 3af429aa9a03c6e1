"""`migan_tpu_torch` never imports JAX: a fresh interpreter imports every
module of the package, runs a tiny forward through the kernel chain and
the demo's preprocessing module, and finds no `jax` in sys.modules."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import migan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(migan_tpu_torch.__path__,
                                                "migan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import torch
from migan_tpu_torch.models.migan_inference import (
    GeneratorConfig, generator_init)
from migan_tpu_torch.models.migan_kernels import KernelGenerator
g = generator_init(GeneratorConfig(resolution=32, ch_base=512),
                   torch.Generator().manual_seed(0))
assert KernelGenerator(g)(torch.zeros(1, 32, 32, 4)).shape == (1, 32, 32, 3)
import migan_tpu.data.preprocess   # what the demo reads files with
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
