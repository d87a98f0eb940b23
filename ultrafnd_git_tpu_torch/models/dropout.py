"""Dropout drawn from an explicit torch.Generator (training mode).

The JAX modules draw their masks from flax's 'dropout' rng stream; the
port's modules take a `torch.Generator` from the caller instead (None means
eval mode: no dropout). Same rule as `flax.linen.Dropout`: keep with
probability 1 - rate and scale kept values by 1 / (1 - rate). The masks are
not the JAX masks (the generators differ); tests compare with dropout off.
"""
from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """x with each element kept with probability 1 - rate, else zeroed."""
    if gen is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(keep, generator=gen)
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
