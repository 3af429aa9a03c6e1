"""`migan_tpu_torch` never imports JAX or any module of `migan_tpu`: a
fresh interpreter imports every module of the package, runs a tiny forward
through the kernel chain, the demo's file readers and writer on a PNG, the
app pipeline, a served request in each of the server's modes and the
evaluation CLI, the export CLI (training weights folded, the kernel
chain exported), the create_pipeline CLI (a bucket and the dynamic
program), one step of the training CLI, a native mask, an ffhqzip
item, an in-loop metric evaluation with a random detector, and a 1-rank
gloo group's gather and gradient all-reduce, and finds neither in
sys.modules. `chip_smoke.py` names neither
in any of its imports, and imports the demo, serve, evaluate, export and
create_pipeline entry points."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile
import torch
torch.set_num_threads(2)   # one of the gate's 6 workers
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

    # the export and create_pipeline CLIs
    from migan_tpu_torch.cli import create_pipeline, export
    from migan_tpu_torch.io import save_train_npz
    from migan_tpu_torch.models import migan
    tg = migan.generator_init(migan.MiganConfig(resolution=32,
                                                num_reparam_tensors=2),
                              torch.Generator().manual_seed(2))
    save_train_npz(f"{d}/t.npz", tg)
    import os
    os.makedirs(f"{d}/ci")
    os.makedirs(f"{d}/cm")
    Image.fromarray(im[0]).save(f"{d}/ci/a.png")
    Image.fromarray(mk[0, :, :, 0]).save(f"{d}/cm/a.png")
    stats = export.main(["--model-path", f"{d}/t.npz", "--resolution", "32",
                       "--num-reparam-tensors", "2", "--origs-dir",
                       f"{d}/ci", "--masks-dir", f"{d}/cm", "--output-dir",
                       f"{d}/ex",
                       "--num-samples", "1", "--device", "cpu"])
    assert stats["diff_pct"] < 0.5
    written = create_pipeline.main([
        "--resolution", "32", "--model-path", f"{d}/ex/models/migan.npz",
        "--images-dir", f"{d}/ci", "--masks-dir", f"{d}/cm",
        "--output-dir", f"{d}/cp",
        "--device", "cpu", "--buckets", "64", "--polymorphic"])
    assert set(written) == {"64", "dynamic"}

    # the training CLI: one step of narrow 8 px nets on a config root
    import yaml
    net = {"resolution": 8, "ch_base": 256, "depthwise": True,
           "reparametrize": True, "num_reparam_tensors": 2}
    os.makedirs(f"{d}/tr/train_256/a")
    os.makedirs(f"{d}/cfg/experiment")
    Image.fromarray(im[0]).save(f"{d}/tr/train_256/a/a.png")
    with open(f"{d}/cfg/experiment/t.yaml", "w") as f:
        yaml.safe_dump({
            "env": {"log_root_dir": f"{d}/runs"},
            "model_g": {"type": "migan_generator", "args": {
                "encoder": {"args": net}, "synthesis": {"args": net}}},
            "model_d": {"type": "migan_discriminator", "args": net},
            "train": {"dataset": {
                "name": "t", "type": "places2", "root_dir": f"{d}/tr",
                "mode": "train256", "loader": [{"type": "DefaultLoader"}],
                "formatter": {"type": "FreeFormMaskFormatter",
                              "args": {"resolution": 8}}},
                "batch_size": 1, "loss_kwargs": {"r1_gamma": 10},
                "g_opt_kwargs": {"lr": 1e-3, "betas": [0, 0.99],
                                 "eps": 1e-8},
                "d_opt_kwargs": {"lr": 1e-3, "betas": [0, 0.99],
                                 "eps": 1e-8},
                "d_reg_interval": 16, "snapshot": {"checkpoint": 1}}}, f)
    from migan_tpu_torch.cli import train
    assert train.main(["--experiment", "t", "--config-root", f"{d}/cfg",
                       "--device", "cpu", "--max-steps", "1"]).step == 1

    # one native mask, one ffhqzip item (with a native mask), and one
    # metric evaluation with a random detector; the detector's features
    # are cut to 64 so that FID's matrix square root stays quick here
    import io, shutil, zipfile
    from migan_tpu_torch.data.factory import get_dataset
    from migan_tpu_torch.evalx import inception, metrics
    native = shutil.which("g++") is not None
    if native:
        from migan_tpu_torch.data.fast_masks import fast_random_mask
        assert fast_random_mask(32, seed=0).shape == (32, 32)
    with zipfile.ZipFile(f"{d}/ffhq256x256.zip", "w") as z:
        for i in range(4):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (32, 32, 3),
                                        np.uint8)).save(buf, format="PNG")
            z.writestr(f"{i:05d}.png", buf.getvalue())
    ds = get_dataset({"name": "z", "type": "ffhqzip", "root_dir": d,
                      "mode": "val256", "loader": [{"type": "ZipLoader"}],
                      "formatter": {"type": "RandomMaskFormatter", "args": {
                          "mask_backend": "native" if native else "pil"}}})
    x, m, uid = ds[0]
    assert x.shape == (32, 32, 3) and m.shape == (32, 32) and uid == "00000"
    det = inception.make_detector(inception.inception_init(0), "nvidia_tf")
    np.random.seed(0)
    r = metrics.calc_metric(
        "fid10k_full_inpainting", dataset=ds, max_items=4, batch_size=2,
        generator_fn=lambda x: migan.generator_apply(tg, x,
                                                     noise_mode="const"),
        detector_fn=lambda x: det(x)[:, :64], cache_dir=f"{d}/fid-cache")
    assert np.isfinite(r["results"]["fid"])

    # a 1-rank gloo group: one all_gather_rows (and its backward) and one
    # gradient all-reduce
    import socket
    from migan_tpu_torch import parallel
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    assert parallel.maybe_initialize_distributed("cpu").type == "cpu"
    assert parallel.backend() == "gloo" and parallel.world() == 1
    w = torch.ones(3, requires_grad=True)
    (gw,) = torch.autograd.grad(
        parallel.all_gather_rows(w[None] * 2).sum(), w)
    assert torch.equal(parallel.all_reduce_mean([gw])[0],
                       torch.full((3,), 2.0))
    parallel.destroy()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "migan_tpu" or m.startswith("migan_tpu."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 66 else 0)
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
    for entry in ("demo", "serve", "evaluate", "export", "create_pipeline"):
        assert f"migan_tpu_torch.cli.{entry}" in mods
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "migan_tpu")]
