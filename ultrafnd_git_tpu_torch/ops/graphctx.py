"""Corpus graph context (counterpart of `ops/graphctx.py:20-53`), numpy only.

The same compact node features and normalised OCR-Jaccard graph the JAX
trainer built the checkpoint on; the graph itself comes from the shared
host builder `ultrafnd_git_tpu.ops.jaccard.build_adj_from_ocr`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from ultrafnd_git_tpu.ops.jaccard import build_adj_from_ocr
from ultrafnd_git_tpu_torch.models.gnn import normalize_adjacency

# Compact per-modality slice widths: text 192 || audio 32 || visual 128 ||
# temporal 64 = 416.
SLICES = (("text", 192), ("audio", 32), ("visual", 128), ("temporal", 64))


def compact_node_features(cache: Dict[str, Any]) -> np.ndarray:
    """(N, 416) row-L2-normalised compact modality concat."""
    xg = np.concatenate(
        [cache[key][:, :width] for key, width in SLICES], axis=1
    ).astype(np.float32)
    xg /= np.linalg.norm(xg, axis=1, keepdims=True) + 1e-9
    return xg


@dataclass
class GraphContext:
    xg: np.ndarray  # (N, F) compact node features
    a_norm: np.ndarray  # D^-1/2 (adj + I) D^-1/2
    ax: np.ndarray  # a_norm @ xg (constant first propagation)
    deg: np.ndarray  # (N,) degrees of (adj + I), what a_norm normalises by


def build_graph_context(cache: Dict[str, Any], thresh: float) -> GraphContext:
    xg = compact_node_features(cache)
    adj = build_adj_from_ocr(cache["ocr_sets"], thresh=thresh)
    a_norm = normalize_adjacency(adj)
    ax = (a_norm @ xg).astype(np.float32)
    # adj already carries diagonal 1 and normalize_adjacency adds I on top,
    # so the effective degree is adj.sum + 1 (diagonal weight 2)
    deg = np.asarray(adj.sum(axis=1) + 1.0, dtype=np.float32)
    return GraphContext(xg=xg, a_norm=a_norm, ax=ax, deg=deg)
