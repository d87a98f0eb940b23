"""Linear and layer-norm layers with Flax's compute-dtype semantics.

Flax's `dtype=jnp.bfloat16` is not `torch.autocast`. `nn.Dense(dtype=bf16)`
casts its input, kernel and bias to bf16 and returns bf16; `nn.LayerNorm(
dtype=bf16)` computes its statistics and normalisation in f32 and returns
bf16; params stay f32 either way. `Dense` and `LayerNorm` here do the same
casts explicitly, with `dtype=None` meaning f32 (exactly torch's
`nn.Linear` / `nn.LayerNorm` on f32 inputs). Both subclass the torch
layers, so state-dict keys and initialisers are unchanged.

Where the port's order of rounding differs from Flax: a bf16 product here
is one cuBLAS (or CPU) bf16 GEMM with f32 sums, rounded to bf16 once, with
the bias added before that rounding; XLA adds the bias to the rounded
product in bf16. Torch's layer norm takes the variance as E[(x - mean)^2]
where Flax takes E[x^2] - E[x]^2. Both are inside the bf16 envelope the
tests hold (|d prob_fake| <= 2e-2).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """`torch.nn.Linear` computed as `flax.linen.Dense(dtype=dtype)`."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """`torch.nn.LayerNorm` computed as `flax.linen.LayerNorm(dtype=dtype)`:
    statistics and normalisation in f32, the result in `dtype` (f32 when
    None, whatever the input's dtype)."""

    def __init__(self, width: int, eps: float, dtype: Optional[torch.dtype] = None):
        super().__init__(width, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y if self.dtype is None else y.to(self.dtype)
