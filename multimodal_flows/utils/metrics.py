"""Evaluation metrics: flavor multiplicities + 1D Wasserstein distances.

Re-design of reference `utils/metrics.py:10-67`: vectorized numpy feature
extraction and a dependency-light W1 (scipy if present, else an exact
numpy implementation of the 1D Wasserstein distance between empirical
distributions).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from multimodal_flows.data.state import MultiModal


def _tokens(sample: Union[MultiModal, np.ndarray]) -> np.ndarray:
    if isinstance(sample, MultiModal):
        sample = sample.discrete
    arr = np.asarray(sample)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


def flavor_multiplicities(sample: Union[MultiModal, np.ndarray]) -> Dict[str, np.ndarray]:
    """16 per-jet token-count observables (reference `metrics.py:10-33`)."""
    s = _tokens(sample)
    neg = (s == 3) | (s == 5) | (s == 7)
    pos = (s == 4) | (s == 6) | (s == 8)
    return {
        "photons": (s == 1).sum(1),
        "h0": (s == 2).sum(1),
        "h-": (s == 3).sum(1),
        "h+": (s == 4).sum(1),
        "e-": (s == 5).sum(1),
        "e+": (s == 6).sum(1),
        "mu-": (s == 7).sum(1),
        "mu+": (s == 8).sum(1),
        "multiplicity": (s > 0).sum(1),
        "hadrons": ((s >= 2) & (s <= 4)).sum(1),
        "leptons": (s > 4).sum(1),
        "neutrals": ((s == 1) | (s == 2)).sum(1),
        "negatives": neg.sum(1),
        "positives": pos.sum(1),
        "isospin": (s == 1).sum(1) - (s == 4).sum(1),
        "net charge": neg.sum(1) - pos.sum(1),
    }


# keep the reference's (misspelled) public name as an alias
flavor_mutliplicities = flavor_multiplicities


def wasserstein1d(x: np.ndarray, y: np.ndarray) -> float:
    """Exact 1D Wasserstein-1 distance between empirical samples."""
    try:
        from scipy.stats import wasserstein_distance

        return float(wasserstein_distance(x, y))
    except ImportError:
        x = np.sort(np.asarray(x, np.float64))
        y = np.sort(np.asarray(y, np.float64))
        all_v = np.sort(np.concatenate([x, y]))
        deltas = np.diff(all_v)
        cdf_x = np.searchsorted(x, all_v[:-1], side="right") / len(x)
        cdf_y = np.searchsorted(y, all_v[:-1], side="right") / len(y)
        return float(np.sum(np.abs(cdf_x - cdf_y) * deltas))


def wasserstein_flavor(sample, test, path: Optional[str] = None) -> Dict[str, float]:
    """W1 distance for every flavor observable, sample vs test; optional
    text-file dump (reference `metrics.py:36-67`)."""
    feats_sample = sample if isinstance(sample, dict) else flavor_multiplicities(sample)
    feats_test = test if isinstance(test, dict) else flavor_multiplicities(test)

    w1 = {k: wasserstein1d(np.asarray(v, np.float64), np.asarray(feats_test[k], np.float64))
          for k, v in feats_sample.items()}

    if path:
        with open(path, "w") as f:
            for key, dist in w1.items():
                f.write(f"{key}: {dist:.4f}\n")
    return w1
