"""Free-form hole mask synthesis (RandomMask / RandomBrush): the port's
own copy of `migan_tpu/data/masks.py` (numpy and PIL), so that the port
imports nothing of `migan_tpu`; for the same RNG it draws the same masks.

Bit-exact re-implementation of the reference generator
(reference: lib/data_factory/ds_ffhq.py:148-225, duplicated in
scripts/evaluate_fid_lpips.py:44-121 and scripts/generate_masks.py:16-93):
up to 10 half-size + 5 full-size rectangles plus <= 20 polyline brush strokes
with per-vertex ellipse caps, rejection-sampled to ``hole_range``.

Mask convention: 1 = known, 0 = hole.

RNG discipline: the reference consumes the *global* numpy RNG in a specific
call order (including two np.random.random() draws per brush stroke whose
PIL transpose results are discarded — a reference quirk kept for seed-0
reproducibility of the eval protocol, reference evaluate_fid_lpips.py:180).
Pass ``rng=np.random`` (default) for that exact behaviour, or a
``np.random.RandomState`` for isolated streams.
"""

from __future__ import annotations

import math

import numpy as np
from PIL import Image, ImageDraw


def RandomBrush(
    max_tries,
    s,
    min_num_vertex=4,
    max_num_vertex=18,
    mean_angle=2 * math.pi / 5,
    angle_range=2 * math.pi / 15,
    min_width=12,
    max_width=48,
    rng=np.random,
):
    H, W = s, s
    average_radius = math.sqrt(H * H + W * W) / 8
    mask = Image.new("L", (W, H), 0)
    for _ in range(rng.randint(max_tries)):
        num_vertex = rng.randint(min_num_vertex, max_num_vertex)
        angle_min = mean_angle - rng.uniform(0, angle_range)
        angle_max = mean_angle + rng.uniform(0, angle_range)
        angles = []
        vertex = []
        for i in range(num_vertex):
            if i % 2 == 0:
                angles.append(2 * math.pi - rng.uniform(angle_min, angle_max))
            else:
                angles.append(rng.uniform(angle_min, angle_max))

        h, w = mask.size
        vertex.append((int(rng.randint(0, w)), int(rng.randint(0, h))))
        for i in range(num_vertex):
            r = np.clip(
                rng.normal(loc=average_radius, scale=average_radius // 2),
                0, 2 * average_radius)
            new_x = np.clip(vertex[-1][0] + r * math.cos(angles[i]), 0, w)
            new_y = np.clip(vertex[-1][1] + r * math.sin(angles[i]), 0, h)
            vertex.append((int(new_x), int(new_y)))

        draw = ImageDraw.Draw(mask)
        width = int(rng.uniform(min_width, max_width))
        draw.line(vertex, fill=1, width=width)
        for v in vertex:
            draw.ellipse((v[0] - width // 2,
                          v[1] - width // 2,
                          v[0] + width // 2,
                          v[1] + width // 2),
                         fill=1)
        # Reference quirk: these transposes are computed and *discarded*
        # (PIL transpose is not in-place); the RNG draws still advance the
        # stream, so they must stay for sequence parity.
        if rng.random() > 0.5:
            mask.transpose(Image.FLIP_LEFT_RIGHT)
        if rng.random() > 0.5:
            mask.transpose(Image.FLIP_TOP_BOTTOM)
    out = np.asarray(mask, np.uint8)
    if rng.random() > 0.5:
        out = np.flip(out, 0)
    if rng.random() > 0.5:
        out = np.flip(out, 1)
    return out


def RandomMask(s, hole_range=(0, 1), rng=np.random):
    """Returns float32 [s, s] mask, 1 = known, 0 = hole."""
    coef = min(hole_range[0] + hole_range[1], 1.0)
    while True:
        mask = np.ones((s, s), np.uint8)

        def Fill(max_size):
            w, h = rng.randint(max_size), rng.randint(max_size)
            ww, hh = w // 2, h // 2
            x = rng.randint(-ww, s - w + ww)
            y = rng.randint(-hh, s - h + hh)
            mask[max(y, 0): min(y + h, s), max(x, 0): min(x + w, s)] = 0

        def MultiFill(max_tries, max_size):
            for _ in range(rng.randint(max_tries)):
                Fill(max_size)

        MultiFill(int(10 * coef), s // 2)
        MultiFill(int(5 * coef), s)
        mask = np.logical_and(mask, 1 - RandomBrush(int(20 * coef), s,
                                                    rng=rng))
        hole_ratio = 1 - np.mean(mask)
        if hole_range is not None and (hole_ratio <= hole_range[0]
                                       or hole_ratio >= hole_range[1]):
            continue
        return mask.astype(np.float32)


def random_mask_uint8(s, hole_range=(0, 1), rng=np.random) -> np.ndarray:
    """255 = known, 0 = hole (reference evaluate_fid_lpips.py:121 flavour)."""
    return (RandomMask(s, hole_range, rng) * 255).astype(np.uint8)


def mask_drawer(backend: str):
    """The mask function of a formatter's `mask_backend`, called as
    f(s, hole_range, rng=rng): 'pil', the reference's generator above;
    'native', the C++ rasterizer of the same algorithm
    (`data/fast_masks.py`, other pixels for the same RNG)."""
    if backend == "pil":
        return RandomMask
    if backend == "native":
        from .fast_masks import fast_random_mask

        return fast_random_mask
    raise ValueError(f"mask_backend must be 'pil' or 'native', got "
                     f"{backend!r}")
