"""`migan_tpu_torch` never imports JAX or any module of `migan_tpu`: a
fresh interpreter imports every module of the package, runs a tiny forward
through the kernel chain, the demo's file readers and writer on a PNG, the
app pipeline, a served request in each of the server's modes and the
evaluation CLI, and finds neither in sys.modules. `chip_smoke.py` names
neither in any of its imports, and imports the demo, serve and evaluate
entry points."""

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

    # the app pipeline and both server modes, on the CPU
    import base64, json
    from migan_tpu_torch.cli import evaluate, serve
    from migan_tpu_torch.export.pipeline import (
        make_pipeline, make_pipeline_stages)
    from migan_tpu_torch.io import save_npz
    save_npz(f"{d}/g.npz", generator_init(GeneratorConfig(resolution=32),
                                          torch.Generator().manual_seed(1)))
    fwd, res = demo.load_model("migan-32", f"{d}/g.npz", "float32", "cpu")
    im = rng.randint(0, 256, (1, 40, 48, 3), np.uint8)
    mk = np.full((1, 40, 48, 1), 255, np.uint8)
    mk[0, 10:20, 12:30] = 0
    assert make_pipeline(fwd, 32, 8, "cpu")(im, mk).shape == (1, 40, 48, 3)
    def b64(path):
        return base64.b64encode(open(path, "rb").read()).decode()
    body = json.dumps({"image": b64(f"{d}/a.png"),
                       "mask": b64(f"{d}/m.png")}).encode()
    b = serve.MicroBatcher(fwd, 32, max_batch=2)
    x, img_r, mask_r = serve._decode_request(body, 32)
    r = b.submit(x)
    r.event.wait()
    assert r.error is None and r.result.shape == (32, 32, 3)
    runner = serve.PipelineRunner(make_pipeline_stages(32, 8, "cpu"), b,
                                  [64])
    im_np, mk_np = serve._decode_pipeline_request(body)
    assert runner.run(im_np, mk_np).shape == im_np.shape
    runner.close()

    # the evaluation CLI's pieces with random detectors (its main, whose
    # 2048-dim matrix square root takes long on a CPU, has its own test)
    from migan_tpu_torch.evalx.fid import fid_from_feature_arrays
    args = evaluate.get_args(["--model-name", "migan-32", "--model-path",
                              f"{d}/g.npz", "--real-dir", d,
                              "--allow-random-detector"])
    inc, lp = evaluate.load_detectors(args, torch.device("cpu"))
    x, imgs, masks, _ = evaluate.InferenceDataset(d, None, 32)[0]
    imgs01 = torch.from_numpy(imgs[None] * 0.5 + 0.5)
    assert inc(imgs01).shape == (1, 2048)
    assert lp(imgs01, imgs01).shape == (1,)
    assert np.isfinite(fid_from_feature_arrays(rng.randn(8, 4),
                                               rng.randn(8, 4)))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "migan_tpu" or m.startswith("migan_tpu."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 34 else 0)
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
            mods.update(f"{node.module}.{a.name}" for a in node.names)
    for entry in ("demo", "serve", "evaluate"):
        assert f"migan_tpu_torch.cli.{entry}" in mods
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "migan_tpu")]
