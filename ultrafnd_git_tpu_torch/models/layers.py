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

`mlp_pair` is the two-layer GELU MLP of the fusion and the classifier
(dropout after each GELU), and on a tensor-parallel mesh its Megatron
form: the first layer holds a column shard (its input enters through
`copy_to`), the second a row shard whose partial products are summed by
`reduce_from` before its bias is added once; the dropout between them
keeps this rank's columns of the global mask.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.models.dropout import Gen, column_shard, dropout
from ultrafnd_git_tpu_torch.parallel.collectives import Shard, copy_to, reduce_from


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


def mlp_pair(first: Dense, second: Dense, x: torch.Tensor, rate: float, gen: Gen,
             tp: Optional[Shard] = None) -> torch.Tensor:
    """drop(gelu(second(drop(gelu(first(x)))))); with `tp`, `first` and
    `second` hold this rank's column and row shards (`parallel/mesh.py`
    `split_dim`) and the result is the full, replicated output."""
    if tp is None:
        h = dropout(F.gelu(first(x)), rate, gen)
        return dropout(F.gelu(second(h)), rate, gen)
    h = dropout(F.gelu(first(copy_to(x, tp))), rate, column_shard(gen, tp.rank, tp.size))
    dt = second.dtype
    partial = F.linear(h if dt is None else h.to(dt),
                       second.weight if dt is None else second.weight.to(dt))
    y = reduce_from(partial.float(), tp) + second.bias
    return dropout(F.gelu(y if dt is None else y.to(dt)), rate, gen)
