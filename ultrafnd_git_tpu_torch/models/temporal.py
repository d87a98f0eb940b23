"""Temporal alignment MLP (counterpart of `models/temporal.py:25-67`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _pad_or_trunc(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-pad or truncate the last axis to `dim`."""
    d = v.shape[-1]
    if d == dim:
        return v
    if d > dim:
        return v[..., :dim]
    return F.pad(v, (0, dim - d))


def cosine01(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Row-wise cosine similarity in [-1, 1], keepdims."""
    xn = x / (x.norm(dim=-1, keepdim=True) + eps)
    yn = y / (y.norm(dim=-1, keepdim=True) + eps)
    return (xn * yn).sum(dim=-1, keepdim=True)


class TemporalAlignMLP(nn.Module):
    """[t, v, t-v, t*v, cos] -> MLP(4D+1 -> 2*out -> out), tanh GELU.

    The JAX module uses Flax's default `nn.gelu`, the tanh approximation
    (unlike fusion, classifier and GCN, which use exact erf).
    """

    def __init__(self, in_dim: int = 768, out_dim: int = 256):
        super().__init__()
        self.in_dim = in_dim
        self.proj_in = nn.Linear(4 * in_dim + 1, 2 * out_dim)
        self.proj_out = nn.Linear(2 * out_dim, out_dim)

    def forward(self, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        v = _pad_or_trunc(v, self.in_dim)
        t = _pad_or_trunc(t, self.in_dim)
        feat = torch.cat([t, v, t - v, t * v, cosine01(t, v)], dim=-1)
        h = F.gelu(self.proj_in(feat), approximate="tanh")
        return self.proj_out(h)
