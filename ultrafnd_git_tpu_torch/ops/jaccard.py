"""OCR-Jaccard graph of a corpus, on the host.

The port's copy of `ultrafnd_git_tpu/ops/jaccard.py`, reduced to
`build_adj_from_ocr` and what it needs. The numpy path is two products of
a binary record-by-token incidence matrix M:

    inter   = M @ M.T
    union   = |s_i| + |s_j| - inter
    A[i, j] = 1  iff  inter / (union + 1e-9) >= thresh  (i != j), A[i, i] = 1

Jaccard of two empty sets is 0. The C++ posting-list builder
(`native/graphops.cpp`) gives the same bits in O(sum_t df_t^2) and is
taken when it builds.
"""
from __future__ import annotations

from typing import Sequence, Set

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
