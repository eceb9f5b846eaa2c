"""FID / KID / Inception-Score statistics.

The port's copy of ``ladi_vton_tpu/metrics/fid.py`` (numpy and scipy
only): the same functions, branches, file names and keys, so a stats
cache written by either package reads in the other; ``sqrtm`` is called
without its ``disp`` argument, which newer SciPy no longer takes.

Equivalent of the reference's clean-fid + torchmetrics metric math
(reference: src/utils/val_metrics.py:132-216, generate_fid_stats.py):

* FID: Frechet distance between gaussian fits of Inception pool3
  features; stats cached per dataset like clean-fid custom stats.
* KID: unbiased polynomial-kernel MMD^2 over pool3 features, averaged
  over random subsets (clean-fid defaults: 100 subsets of 1000).
* IS: exp(mean KL) over logits softmax, 10 splits (torchmetrics
  default).

All math runs in numpy/scipy on host — these are O(d^3) one-shot
computations, not device-bound.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.linalg


def gaussian_stats(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    diff = mu1 - mu2
    # the root alone: the JAX package's ``disp=False`` (which adds an
    # error estimate) is gone from SciPy 1.18, and the root is the same
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def kid_mmd2(
    feats1: np.ndarray,
    feats2: np.ndarray,
    *,
    num_subsets: int = 100,
    subset_size: int = 1000,
    seed: int = 0,
) -> float:
    """Unbiased MMD^2 with kernel (x.y/d + 1)^3, clean-fid style.

    Returns the KID (usually reported x1000).
    """
    n = feats1.shape[1]
    m = min(subset_size, feats1.shape[0], feats2.shape[0])
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = feats2[rng.choice(feats2.shape[0], m, replace=False)]
        y = feats1[rng.choice(feats1.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def inception_score(
    logits: np.ndarray, *, splits: int = 10
) -> tuple[float, float]:
    """IS over softmax of logits (torchmetrics InceptionScore math)."""
    logits = logits.astype(np.float64)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    scores = []
    n = probs.shape[0]
    for chunk in np.array_split(probs, splits):
        if chunk.size == 0:
            continue
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + 1e-16) - np.log(marginal + 1e-16)))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


class StatsCache:
    """mu/sigma (+ raw features for KID) cache, clean-fid custom-stats
    style (reference generate_fid_stats.py:9-40)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> Path:
        return self.root / f"{name}_clean_stats.npz"

    def exists(self, name: str) -> bool:
        return self.path(name).exists()

    def save(self, name: str, mu: np.ndarray, sigma: np.ndarray,
             features: np.ndarray | None = None):
        arrays = {"mu": mu, "sigma": sigma}
        if features is not None:
            arrays["features"] = features
        np.savez(self.path(name), **arrays)

    def load(self, name: str):
        data = np.load(self.path(name))
        feats = data["features"] if "features" in data.files else None
        return data["mu"], data["sigma"], feats
