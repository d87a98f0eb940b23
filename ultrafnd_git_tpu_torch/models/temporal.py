"""Temporal alignment (counterpart of `models/temporal.py:25-67`, `:120-199`).

`TemporalAlignMLP` is the module; `TemporalSyncNet` owns one with fixed
weights and applies it to the whole corpus, as `build_feature_cache`
does. Nobody trains it, so its initial draw is the feature map: U(+-1 /
sqrt(fan_in)) weights and biases, the JAX package's distribution, from a
`torch.Generator` seeded with `seed`. torch cannot repeat the JAX
package's `jax.random.PRNGKey(seed)` draw, so a cache built here differs
from a JAX-built one in `temporal`, `aux[:, 0]` and `evidence[:, 2]`
unless the JAX weights are passed in as `state_dict`
(`utils/transfer.align_state_dict`).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.models.initializers import jax_init_


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


class TemporalSyncNet:
    """A fixed `TemporalAlignMLP` applied row-wise to whole corpora on
    `device`; numpy in, numpy out."""

    def __init__(self, in_dim: int = 768, out_dim: int = 256, seed: int = 0,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device: str = "cpu"):
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.module = TemporalAlignMLP(self.in_dim, self.out_dim)
        if state_dict is None:
            jax_init_("align", self.module, torch.Generator().manual_seed(int(seed)))
        else:
            self.module.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                         for k, v in state_dict.items()})
        self.device = torch.device(device)
        self.module.to(self.device).eval()

    def _apply(self, t: np.ndarray, v: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = self.module(torch.as_tensor(t, dtype=torch.float32).to(self.device),
                              torch.as_tensor(v, dtype=torch.float32).to(self.device))
            return out.cpu().numpy()

    def align_batch(self, T: np.ndarray, V: np.ndarray) -> np.ndarray:
        """(N, in_dim) x (N, Dv) -> (N, out_dim)."""
        return self._apply(T, _pad_or_trunc(torch.as_tensor(V, dtype=torch.float32),
                                            self.in_dim))

    def align_batch_pair(self, T: np.ndarray, V: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(align(T, V), align(T, T)) as one 2N-row pass (exact: the MLP
        works row by row)."""
        t = torch.as_tensor(T, dtype=torch.float32)
        v = _pad_or_trunc(torch.as_tensor(V, dtype=torch.float32), self.in_dim)
        both = self._apply(torch.cat([t, t]), torch.cat([v, t]))
        n = t.shape[0]
        return both[:n], both[n:]
