"""Stratified 70/15/15 split (counterpart of `data/splits.py`).

The same numpy calls in the same order, so a seeded generator gives the
JAX package's indices, including its guards for empty classes and tiny N.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def stratified_indices(y: np.ndarray, frac: float, rng: np.random.Generator) -> np.ndarray:
    """Pick ~frac of each class (at least one per present class)."""
    take = []
    for c in np.unique(y):
        cls_idx = np.where(y == c)[0]
        rng.shuffle(cls_idx)
        k = max(1, int(round(frac * cls_idx.size)))
        take.append(cls_idx[:k])
    return np.concatenate(take) if take else np.array([], dtype=int)


def make_split(
    labels: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stratified (train, val, test) ~ (70, 15, 15) with non-empty guards."""
    n = labels.shape[0]
    all_idx = np.arange(n)
    rng.shuffle(all_idx)

    tr_idx = stratified_indices(labels, 0.70, rng)
    rem = np.setdiff1d(all_idx, tr_idx)

    val_frac_of_rem = 0.0
    if rem.size > 0:
        val_frac_of_rem = min(1.0, 0.15 / (rem.size / float(n)))
    va_idx = rem[stratified_indices(labels[rem], val_frac_of_rem, rng)]
    te_idx = np.setdiff1d(rem, va_idx)

    if tr_idx.size == 0 and n > 0:
        tr_idx = all_idx[: max(1, int(0.7 * n))]
    if va_idx.size == 0 and n > 1:
        va_idx = all_idx[max(1, int(0.7 * n)) : max(1, int(0.85 * n))]
    if te_idx.size == 0 and n > 2:
        te_idx = np.setdiff1d(all_idx, np.concatenate([tr_idx, va_idx]))
    return tr_idx, va_idx, te_idx
