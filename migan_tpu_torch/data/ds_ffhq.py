"""FFHQ datasets, their zip loader and formatters (the port's own copy of
`migan_tpu/data/ds_ffhq.py`; reference lib/data_factory/ds_ffhq.py:21-67,
233-340), numpy NHWC. Images leave a formatter as float32 [H, W, 3] in
[-1, 1], masks as float32 [H, W], 1 = known.

`ffhqzip` is the split of the published FFHQ configs: the PNG entries of
`ffhq{256,512}x{256,512}.zip` sorted by stem, `val*` the first 10,000,
`train*` entries [10000, 70000).
"""

from __future__ import annotations

import io
import json
import os
import os.path as osp
import threading
from typing import Optional
from zipfile import ZipFile

import numpy as np
import PIL.Image

from .factory import ds_base, regdataset, regformat, regloader
from .masks import mask_drawer

PIL.Image.MAX_IMAGE_PIXELS = None


@regdataset()
class ffhq(ds_base):
    """The ffhq-dataset-v2.json manifest (reference ds_ffhq.py:21-67):
    mode 'train', 'val' or both joined by '+'."""

    def init_load_info(self, cfg):
        root_dir = cfg["root_dir"]
        allow_partial = cfg.get("allow_partial", False)
        with open(osp.join(root_dir, "ffhq-dataset-v2.json")) as f:
            jinfo = json.load(f)
        subset = ["training" if m == "train" else
                  "validation" if m == "val" else None
                  for m in cfg["mode"].split("+")]
        self.load_info = []
        for ji in jinfo.values():
            if ji["category"] not in subset:
                continue
            impath = osp.join(root_dir, ji["image"]["file_path"])
            if not osp.isfile(impath):
                if allow_partial:
                    continue
                raise ValueError(impath)
            if not impath.endswith((".jpg", ".png")):
                continue
            modetag = ("00_train" if ji["category"] == "training"
                       else "50_val")
            filename = osp.basename(impath)
            self.load_info.append({
                "unique_id": f"{modetag}-{osp.splitext(filename)[0]}",
                "filename": filename,
                "image_path": impath,
            })


@regdataset()
class ffhqsimple(ds_base):
    """The ffhq256x256/<sub>/<file>.png tree (reference
    ds_ffhq.py:233-254); mode 'train256' only."""

    def init_load_info(self, cfg):
        if cfg["mode"] != "train256":
            raise ValueError(cfg["mode"])
        imagedir = osp.join(cfg["root_dir"], "ffhq256x256")
        self.load_info = []
        for sub in sorted(os.listdir(imagedir)):
            subdir = osp.join(imagedir, sub)
            for fi in sorted(os.listdir(subdir)):
                if ".png" not in fi:
                    continue
                self.load_info.append({
                    "unique_id": osp.splitext(fi)[0],
                    "filename": fi,
                    "image_path": osp.join(subdir, fi),
                })


# mode -> (zip file, [first, last) of the stem-sorted PNG entries)
_ZIP_SPLITS = {
    "train256": ("ffhq256x256.zip", (10000, 70000)),
    "val256": ("ffhq256x256.zip", (0, 10000)),
    "train512": ("ffhq512x512.zip", (10000, 70000)),
    "train512ori": ("ffhq512x512.zip", (10000, 70000)),
    "val512": ("ffhq512x512.zip", (0, 10000)),
    "val512ori": ("ffhq512x512.zip", (0, 10000)),
}


@regdataset()
class ffhqzip(ds_base):
    """ffhq{256,512}x{256,512}.zip with Co-Mod-GAN's split: val the first
    10,000 entries by stem, train [10000, 70000) (reference
    ds_ffhq.py:274-312)."""

    def init_load_info(self, cfg):
        if cfg["mode"] not in _ZIP_SPLITS:
            raise ValueError(cfg["mode"])
        zipname, (lo, hi) = _ZIP_SPLITS[cfg["mode"]]
        zippath = osp.join(cfg["root_dir"], zipname)
        self.load_info = []
        with ZipFile(zippath, "r") as z:
            for fi in z.namelist():
                if ".png" not in fi:
                    continue
                filename = osp.basename(fi)
                self.load_info.append({
                    "unique_id": osp.splitext(filename)[0],
                    "filename": filename,
                    "image_path": fi,
                    "zipfile": zippath,
                })
        self.load_info.sort(key=lambda x: x["unique_id"])
        self.load_info = self.load_info[lo:hi]


@regloader()
class ZipLoader:
    """Decodes an entry of its element's zip to float32 [H, W, 3] in
    [0, 1], through one open handle per loader instance and thread
    (reference ds_ffhq.py:315-336 keeps one per instance). The
    DataLoader's threads share one instance: with a shared handle, one
    thread could close the file another has just opened."""

    def __init__(self):
        self._local = threading.local()

    @property
    def zipfile(self) -> Optional[ZipFile]:
        """The calling thread's open handle, None before its first item."""
        return getattr(self._local, "zipfile", None)

    def __call__(self, element):
        zf = self.zipfile
        if zf is None or zf.filename != element["zipfile"]:
            if zf is not None:
                zf.close()
            zf = self._local.zipfile = ZipFile(element["zipfile"], "r")
        with zf.open(element["image_path"], "r") as f:
            img = PIL.Image.open(io.BytesIO(f.read())).convert("RGB")
        element["image"] = np.asarray(img, np.float32) / 255.0
        return element


@regformat()
class ImageOnlyFormatter:
    """[-1, 1] image, optional random flip (reference ds_ffhq.py:257-265)."""

    def __init__(self, random_flip=False):
        self.random_flip = random_flip

    def __call__(self, element, rng=np.random):
        x = element["image"] * 2 - 1
        if self.random_flip and rng.rand() < 0.5:
            x = x[:, ::-1].copy()
        return x.astype(np.float32), element["unique_id"]


@regformat()
class RandomMaskFormatter:
    """The image at its own resolution, [-1, 1], an optional random flip,
    and a free-form mask (reference ds_ffhq.py:340+). mask_backend 'pil'
    (the reference's generator) or 'native' (the C++ rasterizer), as in
    `ds_places2.FreeFormMaskFormatter`."""

    def __init__(self, random_flip=False, hole_range=(0, 1),
                 mask_backend="pil"):
        self.draw_mask = mask_drawer(mask_backend)
        self.random_flip = random_flip
        self.hole_range = tuple(hole_range)

    def __call__(self, element, rng=np.random):
        x = element["image"] * 2 - 1
        if self.random_flip and rng.rand() < 0.5:
            x = x[:, ::-1].copy()
        mask = self.draw_mask(x.shape[0], self.hole_range, rng=rng)
        return x.astype(np.float32), mask, element["unique_id"]
