"""OCR-Jaccard graph of a corpus, on the host.

The port's copy of `ultrafnd_git_tpu/ops/jaccard.py`, reduced to
`build_adj_from_ocr`, `build_edges_from_ocr` and what they need. The numpy
path is two products of a binary record-by-token incidence matrix M:

    inter   = M @ M.T
    union   = |s_i| + |s_j| - inter
    A[i, j] = 1  iff  inter / (union + 1e-9) >= thresh  (i != j), A[i, i] = 1

Jaccard of two empty sets is 0. The C++ posting-list builder
(`native/graphops.cpp`) gives the same bits in O(sum_t df_t^2) and is
taken when it builds.
"""
from __future__ import annotations

from typing import Optional, Sequence, Set, Tuple

import numpy as np

from ultrafnd_git_tpu_torch import native
from ultrafnd_git_tpu_torch.ops.hashing import token_vocabulary


def incidence_matrix(ocr_sets: Sequence[Set[str]]) -> np.ndarray:
    """Binary (N, V) record-by-token incidence matrix."""
    vocab = token_vocabulary(ocr_sets)
    m = np.zeros((len(ocr_sets), max(1, len(vocab))), dtype=np.float32)
    for i, toks in enumerate(ocr_sets):
        for t in toks:
            m[i, vocab[t]] = 1.0
    return m


def pairwise_jaccard(ocr_sets: Sequence[Set[str]]) -> np.ndarray:
    """Full (N, N) pairwise Jaccard similarity, no threshold."""
    if not len(ocr_sets):
        return np.zeros((0, 0), dtype=np.float32)
    out = native.jaccard_adj_native(ocr_sets, 0.0, mode=2)
    if out is not None:
        return out
    m = incidence_matrix(ocr_sets)
    sizes = m.sum(axis=1)
    inter = m @ m.T
    union = sizes[:, None] + sizes[None, :] - inter
    return (inter / (union + 1e-9)).astype(np.float32)


def build_adj_from_ocr(ocr_sets: Sequence[Set[str]], thresh: float = 0.12) -> np.ndarray:
    """Dense 0/1 (N, N) f32 adjacency: pairwise OCR Jaccard >= thresh, plus
    the diagonal."""
    if not len(ocr_sets):
        return np.zeros((0, 0), dtype=np.float32)
    out = native.jaccard_adj_native(ocr_sets, thresh, mode=0)
    if out is not None:
        return out
    adj = (pairwise_jaccard(ocr_sets) >= thresh).astype(np.float32)
    np.fill_diagonal(adj, 1.0)
    return adj


def build_edges_from_ocr(
    ocr_sets: Sequence[Set[str]],
    thresh: float = 0.12,
    weighted: bool = False,
    block_rows: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric COO edge list (src int32, dst int32, w f32) of the graph:
    the off-diagonal nonzeros of `build_adj_from_ocr` (weights 1, or the
    Jaccard value with `weighted`), both directions, sorted by (src, dst).
    O(E) memory on the native path; the numpy path runs the incidence
    product in row blocks of about 64 MB (`block_rows` pins the block), so
    no (N, N) slab is built, but it holds the dense (N, V) incidence."""
    n = len(ocr_sets)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32)
    out = native.jaccard_edges_native(ocr_sets, thresh, mode=1 if weighted else 0)
    if out is not None:
        return out
    m = incidence_matrix(ocr_sets)
    sizes = m.sum(axis=1)
    srcs, dsts, ws = [], [], []
    block = block_rows or max(1, min(n, (1 << 24) // max(1, n)))
    for s in range(0, n, block):
        inter = m[s:s + block] @ m.T
        union = sizes[s:s + block, None] + sizes[None, :] - inter
        jac = (inter / (union + 1e-9)).astype(np.float32)
        keep = jac >= thresh
        if weighted:  # a weight of 0 is no edge, as on the native path
            keep &= jac > 0
        rows, cols = np.nonzero(keep)
        off = (rows + s) != cols  # the diagonal never contributes an edge
        rows, cols = rows[off], cols[off]
        srcs.append((rows + s).astype(np.int32))
        dsts.append(cols.astype(np.int32))
        ws.append(jac[rows, cols] if weighted else np.ones(len(rows), np.float32))
    src, dst, w = np.concatenate(srcs), np.concatenate(dsts), np.concatenate(ws)
    order = np.lexsort((dst, src))
    return src[order], dst[order], w[order]
