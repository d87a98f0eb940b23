"""Dropout drawn from an explicit torch.Generator (training mode).

The JAX modules draw their masks from flax's 'dropout' rng stream; the
port's modules take a `torch.Generator` from the caller instead (None means
eval mode: no dropout). Same rule as `flax.linen.Dropout`: keep with
probability 1 - rate and scale kept values by 1 / (1 - rate). The masks are
not the JAX masks (the generators differ); tests compare with dropout off.

`draw_mask` and `apply_mask` are the two halves of `dropout`, for a caller
that must draw a mask before the computation it applies to (the tower's
rematerialised blocks: a recompute must apply the masks of the first pass).
"""
from __future__ import annotations

from typing import Optional

import torch


def draw_mask(like: torch.Tensor, rate: float,
              gen: Optional[torch.Generator]) -> Optional[torch.Tensor]:
    """The keep mask (bool, the shape of `like`) of one dropout site, drawn
    from `gen` as `dropout` draws it; None in eval mode."""
    if gen is None or rate <= 0.0:
        return None
    return torch.empty_like(like).bernoulli_(1.0 - rate, generator=gen).bool()


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """x scaled by 1 / (1 - rate) where `mask` keeps it, else 0 (x itself
    for a None mask)."""
    if mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """x with each element kept with probability 1 - rate, else zeroed."""
    return apply_mask(x, draw_mask(x, rate, gen), rate)
