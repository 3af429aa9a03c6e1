"""The training-time metric registry, `fid{5k,10k,36500,50k}_full_inpainting`
(port of `migan_tpu/evalx/metrics.py`; reference lib/evaluator/
stylegan_metrics/metric_main.py:24-117, metric_utils.py:197-296): metrics
by name, real-image feature statistics with an md5-keyed disk cache,
generator-composite statistics, the Frechet distance, timing and a jsonl
sink.

`detector_fn` takes NHWC float in [0, 1] on `device` to [N, 2048]
features (`inception.make_detector`); `generator_fn` takes the
generator's NHWC input [mask - 0.5, image * mask] on `device`. Dataset
items are (image in [-1, 1], mask, uid), numpy.

The datasets are indexed without a per-item RNG (`dataset[i]`), as in the
JAX package: their formatters draw masks (and flips) from the global
`np.random` stream, so an FID repeats only from the same global seed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..utils.logging import print_log
from .fid import FeatureStats, frechet_distance, stats_cache_path

_METRICS: Dict[str, Callable] = {}


def register_metric(fn):
    _METRICS[fn.__name__] = fn
    return fn


def is_valid_metric(name: str) -> bool:
    return name in _METRICS


def list_valid_metrics():
    return list(_METRICS)


def calc_metric(metric: str, **kwargs) -> Dict[str, Any]:
    """Runs a registered metric and packages its results with its wall
    time (reference metric_main.py:37-65)."""
    if not is_valid_metric(metric):
        raise ValueError(f"unknown metric {metric!r} (known: "
                         f"{list_valid_metrics()})")
    start = time.time()
    results = _METRICS[metric](**kwargs)
    return {"results": results, "metric": metric,
            "total_time": time.time() - start}


def report_metric(result_dict: Dict[str, Any], run_dir: Optional[str] = None,
                  snapshot_pkl: Optional[str] = None) -> None:
    """Prints the result as a JSON line and appends it to
    `<run_dir>/metric-<name>.jsonl` (reference metric_main.py:68-88)."""
    line = json.dumps({**result_dict, "snapshot_pkl": snapshot_pkl,
                       "timestamp": time.time()})
    print(line)
    if run_dir is not None and os.path.isdir(run_dir):
        path = os.path.join(run_dir, f"metric-{result_dict['metric']}.jsonl")
        with open(path, "at") as f:
            f.write(line + "\n")


def _count(dataset, max_items: Optional[int]) -> int:
    return len(dataset) if max_items is None else min(len(dataset),
                                                      max_items)


def compute_feature_stats_for_dataset(
    dataset, detector_fn, detector_tag: str, batch_size: int = 32,
    max_items: Optional[int] = None, cache_dir: Optional[str] = None,
    dataset_tag: str = "", device="cpu",
) -> FeatureStats:
    """Features of the dataset's real images, read from the cache file of
    (dataset_tag, detector_tag, max_items) under `cache_dir` when it
    exists, else computed and saved there (reference
    metric_utils.py:197-253)."""
    if cache_dir is not None:
        path = stats_cache_path(cache_dir, dataset_tag, detector_tag,
                                max_items)
        if os.path.isfile(path):
            print_log(f"dataset feature stats read from {path}")
            return FeatureStats.load(path)
    stats = FeatureStats(max_items=max_items)
    n = _count(dataset, max_items)
    for start in range(0, n, batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, n))]
        imgs01 = np.clip(np.stack([it[0] for it in items]) * 0.5 + 0.5, 0, 1)
        feats = detector_fn(torch.from_numpy(imgs01).to(device))
        stats.append(feats.cpu().numpy())
        if stats.is_full():
            break
    if cache_dir is not None:
        stats.save(path)
        print_log(f"dataset feature stats computed, saved to {path}")
    return stats


@torch.no_grad()
def compute_feature_stats_for_inpainting(
    dataset, generator_fn, detector_fn, batch_size: int = 32,
    max_items: Optional[int] = None, device="cpu",
) -> FeatureStats:
    """Features of the generator's composites (reference
    metric_utils.py:256-296): G on [mask - 0.5, image * mask], the known
    pixels from the real image, the hole from G, then the detector."""
    stats = FeatureStats(max_items=max_items)
    n = _count(dataset, max_items)
    for start in range(0, n, batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, n))]
        imgs = torch.from_numpy(np.stack([it[0] for it in items])).to(device)
        masks = torch.from_numpy(
            np.stack([it[1] for it in items])[..., None]).to(device)
        out = generator_fn(torch.cat([masks - 0.5, imgs * masks], dim=-1))
        composed = imgs * masks + out * (1 - masks)
        stats.append(detector_fn(
            (composed * 0.5 + 0.5).clamp(0, 1)).cpu().numpy())
        if stats.is_full():
            break
    return stats


def _fid_full_inpainting(num_items, *, dataset, generator_fn, detector_fn,
                         detector_tag="inception", batch_size=32,
                         cache_dir=None, dataset_tag="", max_items=None,
                         device="cpu") -> Dict[str, float]:
    # max_items: a cap below the metric's own item count (eval.max_items:
    # smoke runs, small validation sets)
    n = num_items if max_items is None else min(num_items, max_items)
    t0 = time.perf_counter()
    real = compute_feature_stats_for_dataset(
        dataset, detector_fn, detector_tag, batch_size, n, cache_dir,
        dataset_tag, device)
    t1 = time.perf_counter()
    fake = compute_feature_stats_for_inpainting(
        dataset, generator_fn, detector_fn, batch_size, n, device)
    t2 = time.perf_counter()
    mu_r, sig_r = real.get_mean_cov()
    mu_f, sig_f = fake.get_mean_cov()
    fid = frechet_distance(mu_f, sig_f, mu_r, sig_r)
    # the features come back to the host as numpy, so each wall time
    # includes the device work before it
    print_log(f"fid time split: real stats {t1 - t0:.3f} s, composite "
              f"stats {t2 - t1:.3f} s, Frechet distance "
              f"{time.perf_counter() - t2:.3f} s")
    return {"fid": fid}


# reference metric_main.py:93-117
@register_metric
def fid5k_full_inpainting(**kw):
    return _fid_full_inpainting(5000, **kw)


@register_metric
def fid10k_full_inpainting(**kw):
    return _fid_full_inpainting(10000, **kw)


@register_metric
def fid36500_full_inpainting(**kw):
    return _fid_full_inpainting(36500, **kw)


@register_metric
def fid50k_full_inpainting(**kw):
    return _fid_full_inpainting(50000, **kw)
