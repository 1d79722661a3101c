"""Value-distribution features: 1-D k-means and exponent statistics.

The port's own copy of ``spgrid/features/values.py`` (``kmeans_1d``,
``ValueFeatures``, ``value_features``), with the same numpy arithmetic, so
that a feature here equals the JAX package's for the same values (pinned by
``tests/test_torch_features.py``). The reference's ``csr_value_features``
and its 1-D k-means characterise how far the values compress.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def kmeans_1d(values: np.ndarray, k: int = 8, iters: int = 25,
              seed: int = 14):
    """Seeded 1-D k-means (random initial centres, Lloyd iterations).
    Returns (centers, labels, inertia)."""
    v = np.asarray(values, dtype=np.float64).ravel()
    if len(v) == 0:
        return np.zeros(0), np.zeros(0, np.int64), 0.0
    k = min(k, len(np.unique(v)))
    rng = np.random.default_rng(seed)
    centers = np.sort(rng.choice(np.unique(v), size=k, replace=False))
    for _ in range(iters):
        # 1-D assignment through the midpoints
        bounds = (centers[1:] + centers[:-1]) / 2
        labels = np.searchsorted(bounds, v)
        new = np.array([
            v[labels == i].mean() if (labels == i).any() else centers[i]
            for i in range(k)
        ])
        if np.allclose(new, centers):
            break
        centers = np.sort(new)
    bounds = (centers[1:] + centers[:-1]) / 2
    labels = np.searchsorted(bounds, v)
    inertia = float(np.sum((v - centers[labels]) ** 2))
    return centers, labels, inertia


@dataclasses.dataclass
class ValueFeatures:
    num_values: int
    num_unique: int
    unique_fraction: float
    mean: float
    std: float
    min: float
    max: float
    exp_min: int            # binary exponent range
    exp_max: int
    exp_unique: int
    kmeans_inertia_8: float  # residual after 8-cluster quantization
    kmeans_rel_error_8: float

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


def value_features(values: np.ndarray, seed: int = 14) -> ValueFeatures:
    v = np.asarray(values, dtype=np.float64).ravel()
    if len(v) == 0:
        return ValueFeatures(0, 0, 0.0, 0, 0, 0, 0, 0, 0, 0, 0.0, 0.0)
    uniq = np.unique(v)
    nz = v[v != 0]
    exps = np.frexp(nz)[1] if len(nz) else np.zeros(1, np.int64)
    centers, labels, inertia = kmeans_1d(v, k=8, seed=seed)
    scale = float(np.mean(np.abs(v))) or 1.0
    rel = float(np.sqrt(inertia / len(v)) / scale)
    return ValueFeatures(
        num_values=len(v),
        num_unique=len(uniq),
        unique_fraction=len(uniq) / len(v),
        mean=float(v.mean()),
        std=float(v.std()),
        min=float(v.min()),
        max=float(v.max()),
        exp_min=int(exps.min()),
        exp_max=int(exps.max()),
        exp_unique=int(len(np.unique(exps))),
        kmeans_inertia_8=inertia,
        kmeans_rel_error_8=rel,
    )
