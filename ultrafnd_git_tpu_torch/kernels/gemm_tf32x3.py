"""The BERT rung's linear products in 3xTF32: the hand-written Hopper kernel
and its plain version.

`linear_tf32x3(x, w_hi, w_lo, bias, gelu)` is Y = X W^T + b (then the
exact-erf GELU with `gelu`) in f32, X (..., K) and W (N, K) as `nn.Linear`
holds it, split once by `split_tf32` into W_hi (W rounded to TF32, the
split of `csrc/tf32_mma.cuh`) and W_lo = W - W_hi. W_hi + W_lo is W
exactly, bit for bit.

* On a CUDA tensor it launches `csrc/gemm_tf32x3.cu` (a persistent TMA +
  `wgmma` kernel for sm_90a: X split in registers, lo * hi + hi * lo +
  hi * hi summed in the tensor cores a 32-deep stage at a time and the
  stages in f32 registers, the bias and the GELU in the epilogue)
  on the current stream and adds one to `launches`. It takes f32,
  contiguous, 16-byte aligned tensors with N % 64 == 0 and K % 32 == 0, no
  input that asks for a gradient (the path is forward-only: the encoder
  runs under `torch.inference_mode`), and raises on anything else; it never
  falls back.
* On a CPU tensor it is the plain version, `F.linear(x, w_hi + w_lo, bias)`
  (then `F.gelu`): the f32 linear on W's own numbers, so the CPU tests see
  the numbers they always saw.

Replaces no TPU kernel: the JAX package leaves these products to XLA. The
library builds with nvcc at first launch (`_build.py`), never at import.
`launches` is safe to add to from several host threads (a lock).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch
import torch.nn.functional as F

from ultrafnd_git_tpu_torch.kernels import _build

# the kernel's tile shapes (rows, columns) by index; 3, used up to 128 rows,
# sums each k8 step's products with compensation (csrc/gemm_tf32x3.cu, "Sums")
SHAPES = ((128, 128), (128, 96), (128, 64), (128, 64))

launches = 0  # kernel launches since import (or since a caller reset it)
_COUNT_LOCK = threading.Lock()
_lib = None
_shape_fn = None


def split_tf32(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 `w`: hi = w rounded to TF32 as `tf32_mma.cuh`'s split
    does (half an ulp added to the bits, the low 13 cleared), lo = w - hi,
    exact, so hi + lo == w."""
    if w.dtype != torch.float32:
        raise ValueError(f"split_tf32 takes float32, not {w.dtype}")
    bits = w.detach().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)  # -0x2000 == 0xffffe000
    return hi, w.detach() - hi


def reference_linear(x: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor,
                     bias: torch.Tensor, gelu: bool = False) -> torch.Tensor:
    """The plain version: the f32 linear on W = w_hi + w_lo, then the GELU."""
    y = F.linear(x, w_hi + w_lo, bias)
    return F.gelu(y) if gelu else y


def _kernel():
    global _lib
    if _lib is None:
        fn = _build.load("gemm_tf32x3").ufnd_gemm_tf32x3
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def tile_shape(m: int, n: int, device=None) -> int:
    """The index into SHAPES of the tile shape the kernel picks at (m, n)
    on the current (or given) CUDA device: by the waves of its SMs it fills."""
    global _shape_fn
    if _shape_fn is None:
        fn = _build.load("gemm_tf32x3").ufnd_gemm_tf32x3_shape
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        _shape_fn = fn
    with torch.cuda.device(device):
        i = _shape_fn(int(m), int(n))
    if i < 0:
        raise RuntimeError(f"gemm_tf32x3: the tile choice failed: cudaError {-i}")
    return i


def _check(x, w_hi, w_lo, bias) -> None:
    n, k = w_hi.shape if w_hi.dim() == 2 else (None, None)
    if n is None or w_lo.shape != w_hi.shape or bias.shape != (n,) or x.shape[-1] != k:
        raise ValueError(f"gemm_tf32x3: shapes x {tuple(x.shape)}, w_hi {tuple(w_hi.shape)}, "
                         f"w_lo {tuple(w_lo.shape)}, bias {tuple(bias.shape)}: want x (..., K), "
                         "w_hi and w_lo (N, K), bias (N,)")
    if n % 64 or k % 32:
        raise ValueError(f"gemm_tf32x3: N = {n}, K = {k}; the kernel takes N % 64 == 0 and "
                         "K % 32 == 0")
    for name, t in (("x", x), ("w_hi", w_hi), ("w_lo", w_lo), ("bias", bias)):
        if t.dtype != torch.float32:
            raise ValueError(f"gemm_tf32x3: {name} is {t.dtype}; the kernel takes float32")
        if t.device != x.device:
            raise ValueError(f"gemm_tf32x3: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"gemm_tf32x3: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"gemm_tf32x3: {name} must be 16-byte aligned (TMA)")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"gemm_tf32x3: {name} requires grad; the kernel is forward-only")


def linear_tf32x3(x: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor,
                  bias: torch.Tensor, gelu: bool = False, shape: int = -1) -> torch.Tensor:
    """Y = X W^T + b (then the exact-erf GELU with `gelu`), (..., N) f32.

    On a CUDA tensor: the 3xTF32 kernel (`shape`: an index into SHAPES to
    force a tile shape, -1 for the kernel's choice); on a CPU tensor:
    `reference_linear`."""
    if x.device.type == "cpu":
        return reference_linear(x, w_hi, w_lo, bias, gelu)
    _check(x, w_hi, w_lo, bias)
    n, k = w_hi.shape
    x2 = x.view(-1, k)
    y = torch.empty((x2.shape[0], n), dtype=torch.float32, device=x.device)
    if x2.shape[0]:
        index = x.device.index
        args = (x2.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), bias.data_ptr(), y.data_ptr(),
                x2.shape[0], n, k, int(bool(gelu)), int(shape),
                torch._C._cuda_getCurrentRawStream(index))
        if index == torch.cuda.current_device():  # the common case, without a device switch
            err = _kernel()(*args)
        else:
            with torch.cuda.device(x.device):
                err = _kernel()(*args)
        if err < 0:
            raise RuntimeError(f"gemm_tf32x3: tensor map encode failed (code {err}: -1 no "
                               f"cuTensorMapEncodeTiled, else -1000 - CUresult) at (M, N, K) "
                               f"{(x2.shape[0], n, k)}")
        if err != 0:
            raise RuntimeError(f"gemm_tf32x3 kernel launch failed: cudaError {err} at (M, N, K) "
                               f"{(x2.shape[0], n, k)}")
        global launches
        with _COUNT_LOCK:
            launches += 1
    return y.view(*x.shape[:-1], n)
