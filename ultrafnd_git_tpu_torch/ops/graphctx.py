"""Corpus graph context (counterpart of `ops/graphctx.py`), numpy only.

The same compact node features and normalised OCR-Jaccard graph the JAX
trainer built the checkpoint on, in two layouts: dense, the (N, N)
`a_norm` from `ops.jaccard.build_adj_from_ocr` on the host,
and sparse (`--sparse_graph`), padded neighbour lists (N, K) from
`ops.jaccard.build_edges_from_ocr`, with no (N, N) object at all.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from ultrafnd_git_tpu_torch.models.gnn import normalize_adjacency
from ultrafnd_git_tpu_torch.ops.jaccard import build_adj_from_ocr, build_edges_from_ocr

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


@dataclass
class SparseGraphContext:
    """Padded neighbour lists of the same normalised graph: O(N K) where the
    dense a_norm is O(N^2) (40 GB at N = 100k in f32). K = 1 + max degree;
    row i holds [self, neighbours in ascending order, padding]: slot 0 is i
    with the self-loop weight 2 d_i d_i, a neighbour slot j weighs d_i d_j,
    padding repeats i with weight 0. d = (deg + 1e-9)^-1/2 in f32, the dense
    path's op order, so the weights agree with `normalize_adjacency` to f32
    rounding."""

    xg: np.ndarray  # (N, F) compact node features
    nbr_idx: np.ndarray  # (N, K) int32 neighbour ids, slot 0 = self
    nbr_w: np.ndarray  # (N, K) f32 normalised weights, 0 = padding
    ax: np.ndarray  # (N, F) = a_norm @ xg, computed from the lists
    deg: np.ndarray  # (N,) degrees of (adj + I), as the dense context's
    k_max: int


def build_sparse_graph_context(cache: Dict[str, Any], thresh: float) -> SparseGraphContext:
    xg = compact_node_features(cache)
    n, f = xg.shape
    src, dst, _ = build_edges_from_ocr(cache["ocr_sets"], thresh=thresh)
    counts = np.bincount(src, minlength=n).astype(np.int64)
    k_max = int(counts.max()) + 1 if n else 1
    if n and k_max > max(64, n // 4):
        # one hub inflates every row to K slots; past about N/4 the dense
        # (N, N) product is both smaller and faster
        warnings.warn(
            f"sparse graph: max degree {k_max - 1} of N={n} makes the padded "
            f"neighbour lists {n}x{k_max} ({n * k_max * 8 / 2**20:.0f} MB); past "
            "about N/4 the dense adjacency is the better layout",
            stacklevel=2,
        )
    # deg_hat = rowsum(adj + I) + 1e-9, adj's diagonal 1 making the self
    # weight 2; d = deg_hat^-1/2; entry = (a_hat d_i) d_j
    d = (counts + 2.0 + 1e-9).astype(np.float32) ** -0.5
    nbr_idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k_max))
    nbr_w = np.zeros((n, k_max), dtype=np.float32)
    nbr_w[:, 0] = (2.0 * d).astype(np.float32) * d
    if len(src):
        # edges are sorted by (src, dst): a slot is the edge's rank in its row + 1
        slot = 1 + np.arange(len(src)) - np.searchsorted(src, np.arange(n))[src]
        nbr_idx[src, slot] = dst
        nbr_w[src, slot] = (1.0 * d[src]).astype(np.float32) * d[dst]
    # a_norm @ xg from the lists, in row chunks of O(chunk K F) floats
    ax = np.empty((n, f), dtype=np.float32)
    chunk = max(1, min(n, (1 << 26) // max(1, k_max * f)))
    for s in range(0, n, chunk):
        ax[s:s + chunk] = np.einsum("rk,rkf->rf", nbr_w[s:s + chunk],
                                    xg[nbr_idx[s:s + chunk]], optimize=True)
    deg = (counts + 2.0).astype(np.float32)
    return SparseGraphContext(xg=xg, nbr_idx=nbr_idx, nbr_w=nbr_w, ax=ax, deg=deg, k_max=k_max)
