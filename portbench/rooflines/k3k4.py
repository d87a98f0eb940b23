"""K3 + K4, the fused f32 flash-attention backward (`csrc/flash_attention_bwd.cu`):
dq, dk, dv of attention over (B, H, S, D), given out, lse and dO.

Operations: five products (S = Q K^T again, dP = dO V^T, dV = P^T dO,
dQ = dS K, dK = dS^T Q), 2 B H S^2 D each: 10 B H S^2 D.
Bytes (f32): q, k, v, out, dO, lse and the bias read; dq, dk, dv written
(no dbias: the trainer's padding bias asks for no gradient)."""
from __future__ import annotations

from typing import Sequence, Tuple

KERNEL = r"\bflash_bwd_kernel<"  # the f32 kernel (the bf16 one is flash_bwd_bf16_kernel)
RATE = "tf32"


def work(shape: Sequence[int]) -> Tuple[float, float]:
    b, h, s, d = shape
    flop = 10.0 * b * h * s * s * d
    nbytes = 4.0 * (8 * b * h * s * d + b * h * s + b * s)
    return flop, nbytes
