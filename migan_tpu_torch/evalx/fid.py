"""Frechet distance for FID: the port's own copy of the standalone-eval
flavor of `migan_tpu/evalx/fid.py` (numpy and SciPy; reference
scripts/evaluate_fid_lpips.py:261-267 / pytorch_fid's
calculate_frechet_distance). One repair: `scipy.linalg.sqrtm` is called
without `disp=False`, an argument that newer SciPy removes; the value is
the same. The training-time streaming statistics (`FeatureStats`) and
their on-disk cache come with the trainer, their only caller.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg


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
