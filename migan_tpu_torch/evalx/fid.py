"""FID statistics and the Frechet distance: the port's own copy of
`migan_tpu/evalx/fid.py` (numpy and SciPy), both flavors of the
reference: the standalone evaluation's (reference
scripts/evaluate_fid_lpips.py:261-267 / pytorch_fid's
calculate_frechet_distance) and the training-time `FeatureStats`, float64
streaming sums with an on-disk cache (reference lib/evaluator/
stylegan_metrics/metric_utils.py:55-137,204-231). One repair:
`scipy.linalg.sqrtm` is called without `disp=False`, an argument that
newer SciPy removes; the value is the same.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional, Tuple

import numpy as np
from scipy import linalg


class FeatureStats:
    """Streaming mean and covariance in float64 (reference
    metric_utils.py:55-137): `append` adds rows until `max_items`, the
    rest of a batch beyond it is dropped."""

    def __init__(self, max_items: Optional[int] = None):
        self.max_items = max_items
        self.num_items = 0
        self.num_features: Optional[int] = None
        self.raw_mean: Optional[np.ndarray] = None
        self.raw_cov: Optional[np.ndarray] = None

    def set_num_features(self, num_features: int) -> None:
        if self.num_features is None:
            self.num_features = num_features
            self.raw_mean = np.zeros([num_features], np.float64)
            self.raw_cov = np.zeros([num_features, num_features], np.float64)
        elif num_features != self.num_features:
            raise ValueError(f"FeatureStats: {num_features} features, "
                             f"expected {self.num_features}")

    def is_full(self) -> bool:
        return (self.max_items is not None
                and self.num_items >= self.max_items)

    def append(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float64)
        if x.ndim != 2:
            raise ValueError(f"FeatureStats: rows of features expected, "
                             f"got shape {x.shape}")
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[:self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        self.raw_mean += x.sum(axis=0)
        self.raw_cov += x.T @ x

    def get_mean_cov(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.num_items == 0:
            raise ValueError("FeatureStats: no items captured")
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items
        return mean, cov - np.outer(mean, mean)

    def save(self, path: str) -> None:
        """Pickles the fields, as the JAX package does: either package
        reads the other's cache file (the JAX package's also holds its
        `capture_mean_cov` switch, always on in its metrics)."""
        with open(path, "wb") as f:
            pickle.dump(self.__dict__, f)

    @staticmethod
    def load(path: str) -> "FeatureStats":
        """A file `save` wrote (it is unpickled: load only this
        program's own cache)."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        obj = FeatureStats()
        obj.__dict__.update(state)
        return obj


def stats_cache_path(cache_dir: str, dataset_tag: str, detector_tag: str,
                     num_items: Optional[int]) -> str:
    """The dataset-statistics cache file under `cache_dir` (created), by
    the md5 of its key (reference metric_utils.py:204-231): the JAX
    package's file name for the same key."""
    key = f"{dataset_tag}-{detector_tag}-{num_items}"
    digest = hashlib.md5(key.encode()).hexdigest()
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"fid-stats-{digest}.pkl")


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """pytorch_fid-compatible Frechet distance
    (reference: frechet_inception_distance.py:52-55 uses the same formula
    via scipy.linalg.sqrtm)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_feature_arrays(real: np.ndarray, fake: np.ndarray) -> float:
    """The standalone-eval flavor: full activation arrays -> np.mean/np.cov
    (reference evaluate_fid_lpips.py:263-267)."""
    mu_r, sig_r = np.mean(real, axis=0), np.cov(real, rowvar=False)
    mu_f, sig_f = np.mean(fake, axis=0), np.cov(fake, rowvar=False)
    return frechet_distance(mu_r, sig_r, mu_f, sig_f)
