"""Classification and forensic metrics in numpy (counterpart of
`ultrafnd_git_tpu/training/metrics.py`, same definitions and keys).

The JAX package computes these with scikit-learn, which the GPU machine
does not have, so the port carries the same formulas in numpy: accuracy,
AUC (the Mann-Whitney form with tied ranks averaged, which is what
`roc_auc_score` computes; 0.5 when one class is absent), precision, recall
and F1 with zero_division=0, CMCS and DFDR. A CPU test holds them against
the JAX package's functions.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_PRINT_ORDER = ("accuracy", "auc", "precision", "recall", "f1", "cmcs", "dfdr")


def safe_auc(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """ROC AUC of positive-class scores; 0.5 when it is undefined."""
    y_true = np.asarray(y_true).astype(int)
    y_prob = np.asarray(y_prob, dtype=float)
    n_pos = int((y_true == 1).sum())
    n_neg = int(y_true.size - n_pos)
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(y_prob, kind="mergesort")
    sorted_p = y_prob[order]
    ranks = np.empty(y_prob.size, dtype=float)
    i = 0
    while i < sorted_p.size:  # average the ranks of tied scores
        j = i
        while j + 1 < sorted_p.size and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    u = ranks[y_true == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def compute_classification_metrics(
    y_true: np.ndarray, y_prob: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """accuracy / auc / precision / recall / f1 of (N,) positive-class probs."""
    y_true = np.asarray(y_true).astype(int)
    y_prob = np.asarray(y_prob, dtype=float)
    y_pred = (y_prob >= threshold).astype(int)
    if not y_true.size:
        return {"accuracy": 0.0, "auc": 0.5, "precision": 0.0, "recall": 0.0,
                "f1": 0.0}
    tp = float(((y_pred == 1) & (y_true == 1)).sum())
    fp = float(((y_pred == 1) & (y_true == 0)).sum())
    fn = float(((y_pred == 0) & (y_true == 1)).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * tp / (2 * tp + fp + fn) if tp + fp + fn else 0.0
    return {
        "accuracy": float((y_pred == y_true).mean()),
        "auc": safe_auc(y_true, y_prob),
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def compute_cmcs(semantic_conflict: np.ndarray, temporal_delay: np.ndarray) -> float:
    """Cross-Modal Consistency Score in [0, 1]; higher = more consistent."""
    sc = np.asarray(semantic_conflict).astype(float)
    td = np.asarray(temporal_delay).astype(float)
    mix = np.clip(0.5 * (sc + td), 0.0, 1.0)
    return float(1.0 - mix.mean()) if mix.size else 0.0


def compute_dfdr(y_true: np.ndarray, y_prob: np.ndarray, threshold: float = 0.5) -> float:
    """DeepFake Detection Rate: TPR on the positive (fake) class."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = (np.asarray(y_prob, dtype=float) >= threshold).astype(int)
    pos = y_true == 1
    if pos.sum() < 1:
        return 0.0
    return float((y_pred[pos] == 1).sum()) / float(pos.sum())


def aggregate_epoch_metrics(
    y_true: np.ndarray,
    y_prob: np.ndarray,
    forensic: Optional[Dict[str, np.ndarray]] = None,
    threshold: float = 0.5,
) -> Dict[str, float]:
    """Per-split / per-epoch metrics, the keys the JAX trainer logs."""
    metrics = compute_classification_metrics(y_true, y_prob, threshold)
    if forensic:
        metrics["cmcs"] = compute_cmcs(
            forensic["semantic_conflict"], forensic["temporal_delay"]
        )
        ei = np.asarray(forensic["emotion_intensity"]).astype(float)
        metrics["emotion_intensity_mean"] = float(ei.mean()) if ei.size else 0.0
        metrics["dfdr"] = compute_dfdr(y_true, y_prob, threshold)
    return metrics


def pretty_print(split: str, m: Dict[str, float]) -> None:
    """Compact, stable-order log line per split (the JAX trainer's format)."""
    line = " | ".join(f"{k}:{m[k]:.4f}" for k in _PRINT_ORDER if k in m)
    extras = [k for k in m if k not in _PRINT_ORDER and not k.startswith("cm_")]
    if extras:
        line += " | " + " ".join(f"{k}:{m[k]:.4f}" for k in extras)
    print(f"[{split}] {line}")
