"""Weight-only int8 serving weights (counterpart of `ops/quant.py:39-118`).

Symmetric, zero-point-free int8 with one f32 scale per output channel:
scale = max|w| / 127 over the channel (1 where the channel is all zero),
q = clip(round(w / scale), -127, 127). Torch's `round`, like `jnp.round`,
rounds half to even, so q and scale equal the JAX package's
`quantize_tree` output exactly. A Flax `kernel` is (in, out) and is
quantized per output column; the port's `Linear.weight` is (out, in), so
the same channels are its rows. An embedding is quantized per row (per
token). Only 2-D weights of at least `min_size` (4096) elements are
quantized; biases, layer norms, the forest and smaller matrices stay f32.

`quantize_modules` swaps each eligible `nn.Linear` for a `QuantDense` and
each eligible `nn.Embedding` for a `QuantEmbedding`, in place. Both keep
the int8 matrix and its scales on the device and dequantize just before
use: a `QuantDense` rebuilds its weight right before its product, a
`QuantEmbedding` gathers the int8 rows of the requested tokens first and
scales only those (the 32768 x 768 table is never rebuilt). Dequantizing
goes to `dequant_dtype` (bf16 under `Predictor(bf16=True)`, as
`dequantize_tree(params, jnp.bfloat16)` does), computing q * scale in that
dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MIN_SIZE = 4096


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 (rows, 1)) of a 2-D weight, one scale per row."""
    w = w.detach().to(torch.float32)
    amax = w.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q * scale, both cast to `dtype` first (`dequantize_tree`'s order)."""
    return q.to(dtype) * scale.to(dtype)


class QuantDense(nn.Module):
    """A Linear layer with an int8 weight, dequantized before each product.

    Computes in the replaced layer's `dtype` (models.layers.Dense) or, for
    a layer without one, in the input's dtype, as a JAX matmul of an f32
    activation with a dequantized kernel does.
    """

    def __init__(self, linear: nn.Linear, dequant_dtype: torch.dtype = torch.float32):
        super().__init__()
        q, scale = quantize_weight(linear.weight)
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", scale)
        self.register_buffer("bias", linear.bias.detach().clone())
        self.dtype = getattr(linear, "dtype", None)
        self.dequant_dtype = dequant_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        w = dequantize(self.weight_q, self.weight_scale, self.dequant_dtype)
        return F.linear(x.to(dt), w.to(dt), self.bias.to(dt))


class QuantEmbedding(nn.Module):
    """An embedding table in int8: gathers the int8 rows and their scales,
    then dequantizes only the gathered rows."""

    def __init__(self, embedding: nn.Embedding, dequant_dtype: torch.dtype = torch.float32):
        super().__init__()
        q, scale = quantize_weight(embedding.weight)
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", scale)
        self.dequant_dtype = dequant_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return dequantize(self.weight_q[ids], self.weight_scale[ids], self.dequant_dtype)


def quantize_modules(
    root: nn.Module,
    dequant_dtype: torch.dtype = torch.float32,
    min_size: int = MIN_SIZE,
) -> Dict[str, int]:
    """Swap every eligible Linear / Embedding under `root` for its int8 form,
    in place. Returns {"quantized": n, "kept": m}, m counting the parameter
    tensors left as they were (the counts `quantize_tree` gives)."""
    stats = {"quantized": 0, "kept": 0}
    swaps = []
    for parent in root.modules():
        for name, child in parent.named_children():
            if isinstance(child, nn.Linear) and child.weight.numel() >= min_size:
                swaps.append((parent, name, QuantDense(child, dequant_dtype)))
            elif isinstance(child, nn.Embedding) and child.weight.numel() >= min_size:
                swaps.append((parent, name, QuantEmbedding(child, dequant_dtype)))
    for parent, name, new in swaps:
        setattr(parent, name, new)
        stats["quantized"] += 1
    stats["kept"] = sum(1 for _ in root.parameters()) + sum(
        1 for m in root.modules() if isinstance(m, QuantDense))
    return stats

