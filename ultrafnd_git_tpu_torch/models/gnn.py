"""Two-layer GCNs (counterpart of `models/gnn.py:29-120`): the v2 trainer's
`SimpleGCN` in both graph layouts, and the integrated trainer's `GNNModel`.

Serving never runs the full-graph forward: the corpus side is precomputed
(`ax = a_norm @ xg` on the host, `h_corpus = gelu(lin1(ax))` once per
Predictor) and a request's rows attach to it through `extend`. Training
runs `propagate` with the trainer's `out_rows` shortcut: the first
propagation `ax` is a constant, so only `a_norm[idx]` rows of the second
are computed; dropout (0.2) hits `h` over all N rows (`gnn.py:93-99`).

The sparse layout (`--sparse_graph`, `ops/graphctx.SparseGraphContext`)
replaces each row of a normalised adjacency by K (index, weight) slots:
a row's propagation is then a gather of K rows and their weighted sum
(`gather_sum`, `gnn.py:81-92`), the same function summed in another order.
`propagate_sparse` and `extend_sparse` are the sparse forms of `propagate`
and `extend`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.models.dropout import dropout as drop


def gather_sum(idx: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """sum_k w[r, k] h[idx[r, k]]: (R, K) slots over the rows of h (N, H)."""
    return torch.einsum("rk,rkh->rh", w, h[idx])


def normalize_adjacency(adj: np.ndarray) -> np.ndarray:
    """D^{-1/2} (A + I) D^{-1/2} in f32 numpy, with the 1e-9 degree epsilon
    and the JAX op order ((a_hat * d_i) * d_j)."""
    adj = np.asarray(adj, dtype=np.float32)
    a_hat = adj + np.eye(adj.shape[0], dtype=np.float32)
    deg = a_hat.sum(axis=-1) + np.float32(1e-9)
    d = deg ** np.float32(-0.5)
    return a_hat * d[:, None] * d[None, :]


def normalize_adjacency_tensor(adj: torch.Tensor) -> torch.Tensor:
    """`normalize_adjacency` on a (B, B) tensor on its device, for graphs
    built in the step (the integrated trainer's weighted sub-graphs)."""
    a_hat = adj + torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)
    d = (a_hat.sum(dim=-1) + 1e-9) ** -0.5
    return a_hat * d[:, None] * d[None, :]


class GNNModel(nn.Module):
    """The ReLU two-layer GCN of the integrated trainer (JAX
    `models/gnn.py:102-120`): lin2(a @ dropout(relu(a @ lin1(x)))) on the
    normalised adjacency a of `adj` (normalize=True) or on `adj` itself.
    Its parameters have the layout and, at the default gnn_dim, the shapes
    of `SimpleGCN`'s; the function differs (lin1 before the propagation,
    ReLU), so a checkpoint of one must not be served as the other."""

    def __init__(self, in_dim: int = 416, hid: int = 256, out_dim: int = 128,
                 dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.lin1 = nn.Linear(in_dim, hid)
        self.lin2 = nn.Linear(hid, out_dim)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                gen: Optional[torch.Generator] = None, normalize: bool = True) -> torch.Tensor:
        a = normalize_adjacency_tensor(adj) if normalize else adj
        h = drop(F.relu(a @ self.lin1(x)), self.dropout, gen)
        return self.lin2(a @ h)


class SimpleGCN(nn.Module):
    """`lin1` / `lin2` of the JAX SimpleGCN (exact GELU between them)."""

    def __init__(self, in_dim: int = 416, hid: int = 256, out_dim: int = 128,
                 dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.lin1 = nn.Linear(in_dim, hid)
        self.lin2 = nn.Linear(hid, out_dim)

    def forward(self, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Dense full-graph forward: lin2(a @ gelu(lin1(a @ x)))."""
        h = F.gelu(self.lin1(a @ x))
        return self.lin2(a @ h)

    def propagate(
        self,
        a_rows: torch.Tensor,
        ax: torch.Tensor,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """lin2(a_rows @ dropout(gelu(lin1(ax)))): the embeddings of the
        nodes whose normalised adjacency rows are `a_rows` (all N rows for
        the full graph, `a_norm[idx]` for a batch); `gen` turns dropout on."""
        return self.lin2(a_rows @ drop(F.gelu(self.lin1(ax)), self.dropout, gen))

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

    def propagate_sparse(
        self,
        nbr_idx: torch.Tensor,
        nbr_w: torch.Tensor,
        ax: torch.Tensor,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """`propagate` with the rows' neighbour lists (R, K) in place of
        their adjacency rows: lin2(gather_sum(dropout(gelu(lin1(ax)))))."""
        h = drop(F.gelu(self.lin1(ax)), self.dropout, gen)
        return self.lin2(gather_sum(nbr_idx, nbr_w, h))

    def extend_sparse(
        self,
        new_idx: torch.Tensor,
        new_w: torch.Tensor,
        self_w: torch.Tensor,
        xg_new: torch.Tensor,
        xg_corpus: torch.Tensor,
        h_corpus: torch.Tensor,
    ) -> torch.Tensor:
        """`extend` with each new node's corpus links as (B, K) slots (index,
        normalised weight; padding weighs 0) in place of its (B, N) row."""
        ax_new = gather_sum(new_idx, new_w, xg_corpus) + self_w[:, None] * xg_new
        h_new = F.gelu(self.lin1(ax_new))
        prop = gather_sum(new_idx, new_w, h_corpus) + self_w[:, None] * h_new
        return self.lin2(prop)
