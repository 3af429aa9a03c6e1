"""Closed loop, one caller, through the app pipeline: one photo and its
mask at a time from host memory through `export.pipeline.make_pipeline`
around `load_model`'s forward, the uint8 composite back to the host with
`.cpu()`, the next call as soon as the last has returned
(`closed_loop.measure`, with a pool of one-photo "batches").

Mix parameters: `pool` seeded photos (`images.photo`) whose [width,
height] cycle through `sizes`, each with one `mask` hole ("object") of a
share of the photo over `hole`; the pipeline's `padding`; `warmup_calls`
before the window, photos of every size among them; `trace_calls` traced
after it with `--trace 1`.

End-to-end candidates: those of `closed_loop` (`forward_ms`: one caller,
so the mean time from host photo to host composite).
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import check, program
from ..reference import pipeline as ref
from . import images
from .closed_loop import State as _State
from .closed_loop import Window, measure, release  # noqa: F401  (the kind)


@dataclass
class State(_State):
    photos: list = None          # (image [H, W, 3], mask [H, W]) uint8


def photos(run) -> list:
    """The pool: item i is `images.body_arrays(seed, mix, i)`, in
    writable arrays, as an app holds a decoded photo."""
    with ThreadPoolExecutor(images.WORKERS) as pool:
        return list(pool.map(lambda i: tuple(map(
            np.array, images.body_arrays(run.seed, run.mix, i))),
            range(run.mix["pool"])))


def setup(run) -> State:
    from migan_tpu_torch.export.pipeline import make_pipeline

    mix = run.mix
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as maker:
        pool = maker.submit(photos, run)
        path = program.write_weights(run)
        pipe = make_pipeline(program.load(run, path),
                             run.config["resolution"],
                             padding=mix["padding"], device=run.device)
        t1 = time.perf_counter()
        items = pool.result()
    t2 = time.perf_counter()

    def forward(b):
        img, mask = items[b[0]]
        return pipe(img[None], mask[None, :, :, None])

    # closed_loop.measure sends batches[b]: here a photo's index
    batches = np.arange(len(items))[:, None]
    order = images.rng(run.seed, 4).permutation(len(items))
    for i in range(mix["warmup_calls"]):
        forward(batches[i % len(items)]).cpu()
    if run.device == "cuda":
        torch.cuda.synchronize()
    print(f"setup: weights and load_model {t1 - t0:.3f} s, then the pool "
          f"{t2 - t1:.3f} s more, warm-up {time.perf_counter() - t2:.3f} s",
          file=sys.stderr)
    return State(forward, batches, order, path, items)


def reference_outputs(run, st: State, idx, tf32: bool = False) -> dict:
    """{b: the reference pipeline's composite [H, W, 3] uint8 of photo b}.
    tf32=True is the control of lower precision."""
    state = program.read_weights(run, st.weights)
    return {b: ref.forward(run.config, state, *st.photos[b],
                           run.mix["padding"], tf32=tf32) for b in idx}


def check_outputs(run, st: State, outputs) -> dict:
    """outputs: (photo index, [1, H, W, 3] uint8 host tensor) pairs, held
    against the reference on the same photo and mask."""
    refs = reference_outputs(run, st, sorted({b for b, _ in outputs}))
    pairs = []
    for b, y in outputs:
        y = np.asarray(y)
        pairs.append((y[0] if y.ndim == 4 and len(y) == 1 else None,
                      refs[b]))
    return check.reply_numbers(pairs)


def verify(run, st: State, win: Window) -> dict:
    return check_outputs(run, st, win.sample)


def control(run, st: State, win: Window) -> dict:
    """The reference with its generator in TF32 put in the program's
    place on the window's sampled photos: the readings that the limits
    must fail."""
    outs = reference_outputs(run, st, sorted({b for b, _ in win.sample}),
                             tf32=True)
    return check_outputs(run, st, [(b, outs[b][None])
                                   for b, _ in win.sample])
