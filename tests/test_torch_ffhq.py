"""The port's FFHQ datasets (`migan_tpu_torch/data/ds_ffhq.py`: `ffhq`,
`ffhqsimple`, `ffhqzip`, `ZipLoader`, `ImageOnlyFormatter`,
`RandomMaskFormatter`) against `migan_tpu.data.ds_ffhq` on the CPU, on
seeded PNG trees, manifests and zips written here: the same uids, images
and formatter outputs (flips, PIL and native masks) for the same per-item
RandomState, compared exactly; `ffhqzip`'s split at entry 10,000 of the
stem-sorted zip (10,008 entries, all but 16 sharing one PNG's bytes);
the published bank names `ffhqzip_{train,val}256_inpainting` through
`ConfigBanks`.
"""

import io
import json
import os
import shutil
import threading
import zipfile

import numpy as np
import pytest
from PIL import Image

from migan_tpu.data import factory as jfactory
from migan_tpu.data import sampler as jsampler
from migan_tpu.utils import config as jconfig
from migan_tpu_torch.data import factory as tfactory
from migan_tpu_torch.data import sampler as tsampler
from migan_tpu_torch.utils import config as tconfig

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
RES = 32
N_ZIP = 10008                 # val: entries [0, 10000), train: the last 8
DISTINCT = (0, 1, 2, 3, 4, 5, 6, 7) + tuple(range(10000, N_ZIP))


def _png(rng, res=RES) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (res, res, 3), np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _native_ok():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native rasterizer cannot be built here")


@pytest.fixture(scope="module")
def ffhq_root(tmp_path_factory):
    """A manifest tree (6 train, 3 val, one listed image missing), an
    ffhqsimple tree and an ffhq256x256.zip, all from one seed."""
    root = tmp_path_factory.mktemp("ffhq")
    rng = np.random.RandomState(0)
    manifest = {}
    for i in range(10):
        cat = "training" if i < 6 else "validation"
        rel = f"images1024x1024/{i // 4:02d}000/{i:05d}.png"
        manifest[str(i)] = {"category": cat, "image": {"file_path": rel}}
        if i != 9:            # listed, not on disk: allow_partial skips it
            os.makedirs(root / os.path.dirname(rel), exist_ok=True)
            (root / rel).write_bytes(_png(rng))
    with open(root / "ffhq-dataset-v2.json", "w") as f:
        json.dump(manifest, f)
    for sub in ("00000", "01000"):
        d = root / "ffhq256x256" / sub
        d.mkdir(parents=True)
        for j in range(3):
            (d / f"{sub[:2]}{j:03d}.png").write_bytes(_png(rng))
    filler = _png(rng)
    order = np.random.RandomState(1).permutation(N_ZIP)  # not stem order
    with zipfile.ZipFile(root / "ffhq256x256.zip", "w",
                         zipfile.ZIP_STORED) as z:
        for i in order:
            z.writestr(f"{i // 1000:02d}000/{i:05d}.png",
                       _png(np.random.RandomState(100 + i))
                       if i in DISTINCT else filler)
        z.writestr("LICENSE.txt", "not an image")
    return str(root)


def _cfg(dtype, root, mode, formatter, fargs=None, loader="DefaultLoader",
         **extra):
    return {"type": dtype, "root_dir": root, "mode": mode,
            "loader": [{"type": loader, "args": {}}],
            "formatter": {"type": formatter, "args": fargs or {}}, **extra}


def _same_items(cfg, positions=None, seed=5):
    """Both packages' datasets of `cfg`: equal uids and items, each item
    made with the same per-item RandomState."""
    got_ds, want_ds = tfactory.get_dataset(cfg), jfactory.get_dataset(cfg)
    assert [e["unique_id"] for e in got_ds.load_info] == \
        [e["unique_id"] for e in want_ds.load_info]
    for pos, idx in enumerate(positions if positions is not None
                              else range(len(got_ds))):
        got = got_ds.__getitem__(idx, rng=tsampler._item_rng(seed, pos))
        want = want_ds.__getitem__(idx, rng=jsampler._item_rng(seed, pos))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    return got_ds


@pytest.mark.parametrize("mode,n", [("train", 6), ("val", 3),
                                    ("train+val", 9)])
def test_ffhq_manifest_equal_to_jax(ffhq_root, mode, n):
    ds = _same_items(_cfg("ffhq", ffhq_root, mode, "RandomMaskFormatter",
                          {"random_flip": True}, allow_partial=True))
    assert len(ds) == n
    assert ds.load_info[0]["unique_id"] == (
        "50_val-00006" if mode == "val" else "00_train-00000")
    if "val" in mode:     # the missing image is a validation one
        with pytest.raises(ValueError, match="00009"):
            tfactory.get_dataset(_cfg("ffhq", ffhq_root, mode,
                                      "ImageOnlyFormatter"))


@pytest.mark.parametrize("flip", [False, True])
def test_ffhqsimple_equal_to_jax(ffhq_root, flip):
    ds = _same_items(_cfg("ffhqsimple", ffhq_root, "train256",
                          "ImageOnlyFormatter", {"random_flip": flip}))
    assert [e["unique_id"] for e in ds.load_info] == [
        "00000", "00001", "00002", "01000", "01001", "01002"]
    x, uid = ds[0]
    assert x.shape == (RES, RES, 3) and -1 <= x.min() and x.max() <= 1


@pytest.mark.parametrize("backend", ["pil", "native"])
@pytest.mark.parametrize("mode", ["train256", "val256"])
def test_ffhqzip_split_and_items_equal_to_jax(ffhq_root, mode, backend):
    if backend == "native":
        _native_ok()
    cfg = _cfg("ffhqzip", ffhq_root, mode, "RandomMaskFormatter",
               {"random_flip": True, "hole_range": [0.0, 1.0],
                "mask_backend": backend}, loader="ZipLoader")
    positions = range(8)
    ds = _same_items(cfg, positions)
    uids = [e["unique_id"] for e in ds.load_info]
    if mode == "val256":
        assert len(ds) == 10000
        assert uids == [f"{i:05d}" for i in range(10000)]
    else:
        assert len(ds) == N_ZIP - 10000
        assert uids == [f"{i:05d}" for i in range(10000, N_ZIP)]
    x, m, _ = ds[0]
    assert x.shape == (RES, RES, 3) and m.shape == (RES, RES)


def test_zip_loader_keeps_one_handle(ffhq_root):
    from migan_tpu_torch.data.ds_ffhq import ZipLoader

    ds = tfactory.get_dataset(_cfg("ffhqzip", ffhq_root, "train256",
                                   "ImageOnlyFormatter", loader="ZipLoader"))
    (loader,) = ds.loaders
    assert isinstance(loader, ZipLoader)
    assert loader.zipfile is None
    ds[0]
    handle = loader.zipfile
    for i in range(1, len(ds)):
        ds[i]
    assert loader.zipfile is handle
    other = []      # another thread opens a handle of its own
    t = threading.Thread(target=lambda: other.append((ds[0],
                                                      loader.zipfile)))
    t.start()
    t.join()
    assert other[0][1] is not None and other[0][1] is not handle
    assert loader.zipfile is handle
    with zipfile.ZipFile(ds.load_info[3]["zipfile"]) as z:
        raw = z.read(ds.load_info[3]["image_path"])
    img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"),
                     np.float32) / 255.0
    np.testing.assert_array_equal(ds[3][0], img * 2 - 1)


def test_zip_loader_through_threaded_data_loader(ffhq_root):
    """Eight DataLoader threads share one ZipLoader from their first items
    on (a fresh dataset each round): every batch equals the items read
    one by one."""
    cfg = _cfg("ffhqzip", ffhq_root, "val256", "ImageOnlyFormatter",
               loader="ZipLoader")
    idx = list(range(64))
    ref = tfactory.get_dataset(cfg)
    want = np.stack([ref[i][0] for i in idx])
    for _ in range(3):
        ds = tfactory.get_dataset(cfg)
        got = [b[0] for b in tsampler.DataLoader(ds, batch_size=2,
                                                 indices=idx, num_workers=8)]
        np.testing.assert_array_equal(np.concatenate(got), want)


@pytest.mark.parametrize("backend", ["pil", "native"])
@pytest.mark.parametrize("name", ["ffhqzip_train256_inpainting",
                                  "ffhqzip_val256_inpainting"])
def test_bank_names_resolve_and_load_as_in_jax(ffhq_root, name, backend):
    """The published experiment's datasets through `ConfigBanks`, rooted
    at the seeded zip, with either mask backend."""
    if backend == "native":
        _native_ok()
    got = tconfig.ConfigBanks(CONFIGS).dataset(name)
    want = jconfig.ConfigBanks(CONFIGS).dataset(name)
    assert got == want
    got["root_dir"] = ffhq_root
    got["formatter"]["args"]["mask_backend"] = backend
    ds = _same_items(got, range(4), seed=2)
    assert len(ds) == (10000 if "val" in name else N_ZIP - 10000)


def test_unknown_zip_mode_raises(ffhq_root):
    with pytest.raises(ValueError, match="train1024"):
        tfactory.get_dataset(_cfg("ffhqzip", ffhq_root, "train1024",
                                  "ImageOnlyFormatter", loader="ZipLoader"))
