"""Seeded inputs: photo-like images, free-form stroke masks and object
holes, the closed-loop pool of model inputs, and the serve mix's request
bodies. numpy and PIL only, so the sender process starts fast.

Every seed gets the same sizes and hole shares, in another order: an
item's size and hole target depend on its index alone, its pixels on the
seed and the index, and the order of use on the seed.
"""

from __future__ import annotations

import base64
import io
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image, ImageDraw, ImageFilter

WORKERS = 4      # threads that make a pool; PIL and numpy release the GIL


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, *salt])


def photo(g: np.random.Generator, w: int, h: int) -> np.ndarray:
    """[h, w, 3] uint8: a smooth colour field, a few flat objects with
    hard edges, softened by one pixel, and fine grain."""
    field = Image.fromarray(g.integers(0, 256, (4, 4, 3), dtype=np.uint8))
    img = field.resize((w, h), Image.BICUBIC)
    draw = ImageDraw.Draw(img)
    for _ in range(int(g.integers(4, 9))):
        x0, y0 = g.integers(0, w), g.integers(0, h)
        dx, dy = g.integers(w // 16, w // 3), g.integers(h // 16, h // 3)
        box = [int(x0), int(y0), int(x0 + dx), int(y0 + dy)]
        color = tuple(int(c) for c in g.integers(0, 256, 3))
        (draw.ellipse if g.random() < 0.5 else draw.rectangle)(box,
                                                               fill=color)
    img = img.filter(ImageFilter.GaussianBlur(1))
    grain = g.integers(-6, 7, (64, 64, 3), dtype=np.int16)
    a = np.asarray(img, np.int16)
    a = a + np.tile(grain, (h // 64 + 1, w // 64 + 1, 1))[:h, :w]
    return np.clip(a, 0, 255).astype(np.uint8)


def stroke_mask(g: np.random.Generator, w: int, h: int,
                hole: float) -> np.ndarray:
    """[h, w] uint8, 255 = known, 0 = hole: thick random-walk strokes
    drawn until at least `hole` of the area is covered."""
    m = Image.new("L", (w, h), 255)
    draw = ImageDraw.Draw(m)
    side = min(w, h)
    target = int(hole * w * h)
    while True:
        n = int(g.integers(4, 10))
        pts = [(float(g.uniform(0, w)), float(g.uniform(0, h)))]
        for _ in range(n):
            a = g.uniform(0, 2 * np.pi)
            r = g.uniform(side / 16, side / 5)
            x, y = pts[-1]
            pts.append((x + r * np.cos(a), y + r * np.sin(a)))
        width = int(g.integers(side // 40 + 1, side // 12 + 2))
        draw.line(pts, fill=0, width=width, joint="curve")
        if w * h - np.count_nonzero(np.asarray(m)) >= target:
            return np.asarray(m)


def object_mask(g: np.random.Generator, w: int, h: int,
                hole: float) -> np.ndarray:
    """[h, w] uint8, 255 = known: one object-sized hole, an ellipse of
    `hole` of the area with a jagged rim, away from the borders."""
    area = hole * w * h
    aspect = g.uniform(0.6, 1.6)
    ry = np.sqrt(area / np.pi / aspect)
    rx = ry * aspect
    cx = g.uniform(rx + 8, w - rx - 8)
    cy = g.uniform(ry + 8, h - ry - 8)
    t = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    jag = 1 + 0.08 * g.standard_normal(48)
    pts = list(zip(cx + rx * jag * np.cos(t), cy + ry * jag * np.sin(t)))
    m = Image.new("L", (w, h), 255)
    ImageDraw.Draw(m).polygon([(float(x), float(y)) for x, y in pts], fill=0)
    return np.asarray(m)


def holes(lo: float, hi: float, n: int) -> np.ndarray:
    """n hole targets spread evenly over [lo, hi]."""
    return np.linspace(lo, hi, n)


def model_input(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[H, W, 4] float32 = concat(mask - 0.5, rgb * mask), rgb in
    [-1, 1], mask 1 = known."""
    m = (mask >= 255).astype(np.float32)[..., None]
    rgb = img.astype(np.float32) * (2.0 / 255.0) - 1.0
    return np.concatenate([m - 0.5, rgb * m], axis=-1)


def closed_pool(seed: int, n: int, res: int, hole_lo: float,
                hole_hi: float) -> np.ndarray:
    """[n, res, res, 4] float32 model inputs: item i has hole share
    holes(lo, hi, n)[i] under free-form strokes."""
    out = np.empty((n, res, res, 4), np.float32)
    targets = holes(hole_lo, hole_hi, n)

    def make(i):
        g = rng(seed, 1, i)
        out[i] = model_input(photo(g, res, res),
                             stroke_mask(g, res, res, targets[i]))

    with ThreadPoolExecutor(WORKERS) as pool:
        list(pool.map(make, range(n)))
    return out


def body_size(mix: dict, i: int):
    """(width, height) of body i: the mix's sizes in turn."""
    w, h = mix["sizes"][i % len(mix["sizes"])]
    return int(w), int(h)


def body_arrays(seed: int, mix: dict, i: int):
    """(image [h, w, 3] uint8, mask [h, w] uint8) of body i."""
    w, h = body_size(mix, i)
    n = mix["pool"]
    # hole targets cycle independently of the sizes
    hole = holes(mix["hole"][0], mix["hole"][1], n)[(i * 7919) % n]
    g = rng(seed, 2, i)
    img = photo(g, w, h)
    make = object_mask if mix["mask"] == "object" else stroke_mask
    return img, make(g, w, h, hole)


def encode(img: np.ndarray, mask: np.ndarray, quality: int) -> bytes:
    """The request body: JSON of a base64 JPEG image and PNG mask."""
    jb, mb = io.BytesIO(), io.BytesIO()
    Image.fromarray(img).save(jb, format="JPEG", quality=quality)
    Image.fromarray(mask).save(mb, format="PNG", compress_level=1)
    return json.dumps({"image": base64.b64encode(jb.getvalue()).decode(),
                       "mask": base64.b64encode(mb.getvalue()).decode()}
                      ).encode()


def body(seed: int, mix: dict, i: int) -> bytes:
    return encode(*body_arrays(seed, mix, i), mix["jpeg_quality"])
