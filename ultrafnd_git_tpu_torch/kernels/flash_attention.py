"""Flash-attention forward: the hand-written Hopper kernel and its plain twin.

`flash_attention_fwd(q, k, v, bias) -> (out, lse)` is the counterpart of
`ultrafnd_git_tpu/kernels/flash_attention.py::_pallas_forward` (kernel
`_make_fwd_kernel`): attention over (B, H, S, D) with an additive
key-padding bias of shape (B, 1, 1, S), softmax in f32, and the per-row
logsumexp. On a CUDA tensor it launches `csrc/flash_attention_fwd.cu`
(built with nvcc for sm_90a at first use, see `_build.py`) or raises; it
never falls back. On a CPU tensor it runs `reference_attention`, the plain
PyTorch version the tests hold against the JAX kernel.

`launches` counts kernel launches (and nothing else), so a run can show
that its path went through the kernel; the CPU path leaves it unchanged.

Forward only: the backward kernels (K3, K4 in ROADMAP.md) come with the
trainable tower, so a CUDA call that would need gradients raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ultrafnd_git_tpu_torch.kernels import _build

NEG_INF = -1e9
HEAD_DIMS = (64, 128, 192, 256)  # the kernel's compiled head widths

launches = 0  # kernel launches since import (or since a caller reset it)
_lib = None


def _scale(dim: int) -> float:
    # 1 / sqrt(D) rounded the way the JAX kernel computes it (f32 sqrt,
    # f32 divide), so kernel, plain version and reference scale alike
    return float(np.float32(1.0) / np.sqrt(np.float32(dim)))


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention with the kernel's outputs: (out (B,H,S,D), lse (B,H,S))."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * _scale(q.shape[-1])
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v) / denom
    return out, (m + torch.log(denom)).squeeze(-1)


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention_fwd")
        fn = lib.ufnd_flash_attention_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _check(q, k, v, bias) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D), got shape {tuple(q.shape)}")
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if bias.shape != (b, 1, 1, s):
        raise ValueError(
            f"bias must be (B, 1, 1, S) = {(b, 1, 1, s)}, got "
            f"{tuple(bias.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if s < 1 or b * h < 1:
        raise ValueError(f"empty attention shape {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, bias)
    ):
        raise RuntimeError(
            "flash_attention_fwd is forward-only: the backward kernels (K3 "
            "dQ, K4 dK/dV in ROADMAP.md) are not ported yet; call it under "
            "torch.inference_mode() or torch.no_grad()"
        )


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B,H,S,D), lse (B,H,S) f32) of softmax(q k^T / sqrt(D) + bias) v.

    q, k, v: (B, H, S, D) float32, D in HEAD_DIMS; bias: (B, 1, 1, S)
    float32 additive mask (0 / NEG_INF), None for no mask. A CUDA call
    launches the kernel on the current stream and adds one to `launches`;
    it raises on a shape, dtype, layout or launch it cannot take. A CPU
    call returns `reference_attention`.
    """
    if bias is None:
        bias = torch.zeros(
            (q.shape[0], 1, 1, q.shape[2]), dtype=q.dtype, device=q.device
        )
    if q.device.type == "cpu":
        return reference_attention(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    _check(q, k, v, bias)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, h, s, d, _scale(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd kernel launch failed: cudaError {err} "
            f"at shape {(b, h, s, d)}"
        )
    global launches
    launches += 1
    return out, lse


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, S) 1/0 validity mask -> additive (B, 1, 1, S) f32 bias."""
    return ((1.0 - mask.to(torch.float32)) * NEG_INF)[:, None, None, :]
