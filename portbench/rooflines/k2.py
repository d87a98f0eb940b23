"""K2, the f32 flash-attention forward (`csrc/flash_attention_fwd.cu`):
softmax(q k^T / sqrt(D) + bias) v over (B, H, S, D), with its lse.

Operations: two products, Q K^T and P V, 2 B H S^2 D each: 4 B H S^2 D.
Bytes (f32): q, k, v and the (B, 1, 1, S) bias read; out and the (B, H, S)
lse written."""
from __future__ import annotations

from typing import Sequence, Tuple

KERNEL = r"\bflash_fwd_kernel<"  # the f32 kernel (the bf16 one is flash_fwd_bf16_kernel)
RATE = "tf32"  # f32 inputs: the dense TF32 rate


def work(shape: Sequence[int]) -> Tuple[float, float]:
    b, h, s, d = shape
    flop = 4.0 * b * h * s * s * d
    nbytes = 4.0 * (4 * b * h * s * d + b * s + b * h * s)
    return flop, nbytes
