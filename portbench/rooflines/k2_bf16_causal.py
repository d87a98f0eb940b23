"""K2-bf16's causal mode (`csrc/flash_attention_fwd_bf16.cu`, its causal
instantiation): softmax(q k^T / sqrt(D) + bias) v over the keys at or
before each query, over (B, H, S, D) with H query heads over KV heads
(GQA), with its lse.

Operations: two products over the causal triangle, Q K^T and P V, 2 B H D
S (S + 1) / 2 each: 2 B H D S (S + 1). Bytes (bf16 q, k, v, out and the
(B, 1, 1, S) bias; f32 lse): q at H heads, k and v at KV heads and the
bias read, out at H heads and lse written. The call takes K and V repeated
to H heads (a copy before it); the function needs them once, at KV heads,
so reading the repeated heads counts against the kernel."""
from __future__ import annotations

from typing import Sequence, Tuple

KERNEL = r"flash_fwd_bf16_kernel<\d+, true>"  # the causal instantiation alone
RATE = "bf16"


def work(shape: Sequence[int]) -> Tuple[float, float]:
    b, h, s, d, kv = shape
    flop = 2.0 * b * h * d * s * (s + 1)
    nbytes = 2.0 * (2 * b * h * s * d + 2 * b * kv * s * d + b * s) + 4.0 * b * h * s
    return flop, nbytes
