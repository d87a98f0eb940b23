"""Oblivious-tree forest routing (counterpart of `ops/trees.py:24-64`).

Both contractions run in full f32 (the JAX side asks for
Precision.HIGHEST; on the card that needs TF32 off, which
`utils.device.resolve_device` sets).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def leaf_bit_matrix(depth: int) -> np.ndarray:
    """(depth, 2^depth) 0/1; bits[k, l] = 1 iff leaf l goes right at depth k."""
    leaves = np.arange(1 << depth)
    ks = np.arange(depth)
    return ((leaves[None, :] >> ks[:, None]) & 1).astype(np.float32)


def oblivious_forest_logits(
    x: torch.Tensor,
    gates: torch.Tensor,
    thresh: torch.Tensor,
    leaf_logits: torch.Tensor,
    tau: float,
    bits: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (B, F), gates (T, K, F), thresh (T, K), leaf_logits (T, 2^K, C)
    -> per-tree logits (B, T, C). `bits` is `leaf_bit_matrix(K)` as a tensor
    on x's device (made here when not given; a module passes its buffer, so
    a traced program holds no tensor of its own)."""
    depth = gates.shape[1]
    alpha = torch.exp(gates - gates.amax(dim=-1, keepdim=True))
    alpha = alpha / alpha.sum(dim=-1, keepdim=True)  # softmax over features
    choice = torch.einsum("bf,tkf->btk", x, alpha)
    s = 1.0 / (1.0 + torch.exp(-tau * (choice - thresh)))  # right prob
    if bits is None:
        bits = torch.as_tensor(leaf_bit_matrix(depth), device=x.device)
    branch = bits * s[..., None] + (1.0 - bits) * (1.0 - s[..., None])
    leaf_probs = branch.prod(dim=2)  # (B, T, L)
    return torch.einsum("btl,tlc->btc", leaf_probs, leaf_logits)
