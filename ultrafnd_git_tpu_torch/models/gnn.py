"""Two-layer GCN (counterpart of `models/gnn.py:29-99`, dense branch).

Serving never runs the full-graph forward: the corpus side is precomputed
(`ax = a_norm @ xg` on the host, `h_corpus = gelu(lin1(ax))` once per
Predictor) and a request's rows attach to it through `extend`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def normalize_adjacency(adj: np.ndarray) -> np.ndarray:
    """D^{-1/2} (A + I) D^{-1/2} in f32 numpy, with the 1e-9 degree epsilon
    and the JAX op order ((a_hat * d_i) * d_j)."""
    adj = np.asarray(adj, dtype=np.float32)
    a_hat = adj + np.eye(adj.shape[0], dtype=np.float32)
    deg = a_hat.sum(axis=-1) + np.float32(1e-9)
    d = deg ** np.float32(-0.5)
    return a_hat * d[:, None] * d[None, :]


class SimpleGCN(nn.Module):
    """`lin1` / `lin2` of the JAX SimpleGCN (exact GELU between them)."""

    def __init__(self, in_dim: int = 416, hid: int = 256, out_dim: int = 128):
        super().__init__()
        self.lin1 = nn.Linear(in_dim, hid)
        self.lin2 = nn.Linear(hid, out_dim)

    def forward(self, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Dense full-graph forward: lin2(a @ gelu(lin1(a @ x)))."""
        h = F.gelu(self.lin1(a @ x))
        return self.lin2(a @ h)

    def corpus_hidden(self, ax: torch.Tensor) -> torch.Tensor:
        """Layer-1 activations of the corpus, gelu(lin1(a_norm @ xg))."""
        return F.gelu(self.lin1(ax))

    def extend(
        self,
        a_rows: torch.Tensor,
        self_w: torch.Tensor,
        xg_new: torch.Tensor,
        xg_corpus: torch.Tensor,
        h_corpus: torch.Tensor,
    ) -> torch.Tensor:
        """Embeddings of new nodes attached to the corpus graph.

        a_rows (B, N): normalised adjacency rows of the new nodes against
        the corpus; self_w (B,): their self-loop weight (2 / deg_new).
        Layer 1 sees a_rows @ xg + self_w * x_new, layer 2 propagates
        a_rows @ h_corpus + self_w * h_new (serving.py:529-550).
        """
        ax_new = a_rows @ xg_corpus + self_w[:, None] * xg_new
        h_new = F.gelu(self.lin1(ax_new))
        prop = a_rows @ h_corpus + self_w[:, None] * h_new
        return self.lin2(prop)
