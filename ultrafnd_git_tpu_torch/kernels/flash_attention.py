"""Flash attention: the hand-written Hopper kernels and their plain twins.

`flash_attention(q, k, v, bias)` is what the text tower calls: attention
over (B, H, S, D) with an additive key-padding bias of shape (B, 1, 1, S),
softmax in f32, differentiable in q, k, v (and bias when it asks for a
gradient), in f32 or in bf16. Its forward is a `torch.library` custom op,
so that `torch.export` can trace a program that holds the tower (the fake
implementation gives the shapes; the real one launches the kernel), and
the op's registered gradient is the fused backward:

* forward `flash_attention_fwd(q, k, v, bias) -> (out, lse)`, the
  counterpart of `ultrafnd_git_tpu/kernels/flash_attention.py::
  _pallas_forward` (kernel `_make_fwd_kernel`, K2) with f32 matmuls: on a
  CUDA tensor it launches `csrc/flash_attention_fwd.cu`, products on the
  tensor cores (3xTF32) with the online softmax in f32;
* for bf16 q, k, v, forward `flash_attention_fwd_bf16(q, k, v, bias)`,
  K2's bf16 mode (`mm_dtype=bfloat16`, the TPU kernel's default): on a
  CUDA tensor it launches `csrc/flash_attention_fwd_bf16.cu`, both products
  bf16 with f32 sums, the softmax in f32, P rounded to bf16 for P V, out
  bf16 and lse f32;
* for bf16 q, k, v whose queries attend to keys at or before them alone,
  forward `flash_attention_fwd_bf16_causal(q, k, v, bias)`, K2-bf16's
  causal mode (the language-model rung, `models/lfm2.py`): the same kernel
  source instantiated with its causal flag, which reads only the key tiles
  at or before each query tile and masks the diagonal tile; forward only
  (no backward is registered: no causal path trains);
* backward `flash_attention_bwd(q, k, v, bias, out, lse, do) -> (dq, dk,
  dv, dbias)`, the counterpart of `_pallas_backward` (kernels
  `_make_bwd_dq_kernel`, K3, and `_make_bwd_dkv_kernel`, K4): on a CUDA
  tensor it launches `csrc/flash_attention_bwd.cu`, one pass on the
  tensor cores (3xTF32) that computes delta, dQ, dK, dV and the dbias
  partials together;
* for bf16 q, k, v, backward `flash_attention_bwd_bf16(...)`, K3's and
  K4's bf16 mode: on a CUDA tensor it launches
  `csrc/flash_attention_bwd_bf16.cu`, the same fused pass with bf16
  products and f32 sums, dS and P rounded to bf16 before they enter a
  product, dq, dk, dv bf16 and dbias in the bias's dtype.

Each builds with nvcc for sm_90a at first use (`_build.py`) and raises on a
failed build or launch; none falls back. On a CPU tensor they run the
plain PyTorch versions, `reference_attention`, `reference_attention_bf16`
(both with a `causal` flag),
`attention_bwd_reference` and `attention_bwd_reference_bf16`, which the
tests hold against the JAX kernels. The backward recomputes P = exp(s -
lse) as the TPU kernels do, so on a row whose keys are all masked P is 1
per key rather than 1/S (see the note in `csrc/flash_attention_bwd.cu`);
rows with a valid key agree with autograd of a softmax.

`launches` counts f32 forward launches, `bf16_launches` bf16 forward
launches, `bf16_causal_launches` causal bf16 forward launches,
`bwd_launches` f32 backward launches and `bwd_bf16_launches` bf16
backward launches (one per backward call, K3 and K4 fused), and nothing
else, so a run can show that its path went through the kernels and in which
mode; the CPU path leaves all five unchanged. Under
`torch.inference_mode()` only K2 runs. The counts are safe to add to from
several host threads (a lock); each library is built and loaded once under
`_build`'s lock, whichever thread launches first.

The ops are `ufnd::flash_attention_fwd`, `ufnd::flash_attention_fwd_bf16` and
`ufnd::flash_attention_fwd_bf16_causal`, (q, k, v, bias) -> (out, lse),
registered when this module is imported:
the CPU implementation is the plain version, the CUDA one the kernel
launch with its checks and counter, and `torch.library.register_autograd`
gives the first two the fused K3 + K4 backward (K3/K4 stay ctypes calls: no
exported program holds a backward). A program exported with
`torch.export` calls the op by name, so whoever loads it imports this
module first.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ultrafnd_git_tpu_torch.kernels import _build

NEG_INF = -1e9
HEAD_DIMS = (64, 128, 192, 256)  # the kernel's compiled head widths

launches = 0  # K2 (f32) launches since import (or since a caller reset it)
bf16_launches = 0  # K2 bf16-mode launches
bf16_causal_launches = 0  # K2 bf16-mode causal launches
bwd_launches = 0  # f32 backward (K3 + K4 fused) launches, one per call
bwd_bf16_launches = 0  # bf16-mode backward launches, one per call
# a count is read, added to and written back under this lock: the text
# ladder's tower launches K2 from featurize threads while scoring launches it
# from another (serving.Predictor, server.DynamicBatcher)
_COUNT_LOCK = threading.Lock()
_lib = None
_bf16_lib = None
_bf16_causal_lib = None
_bwd_lib = None
_bwd_block_keys = None
_bwd_bf16_lib = None
_bwd_bf16_block_keys = None


def _scale(dim: int) -> float:
    # 1 / sqrt(D) rounded the way the JAX kernel computes it (f32 sqrt,
    # f32 divide), so kernel, plain version and reference scale alike
    return float(np.float32(1.0) / np.sqrt(np.float32(dim)))


def _causal(s: torch.Tensor) -> torch.Tensor:
    """Scores (..., S, S) with every key after its query at -inf."""
    n = s.shape[-1]
    later = torch.ones((n, n), dtype=torch.bool, device=s.device).triu(1)
    return s.masked_fill(later, float("-inf"))


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention with the kernel's outputs: (out (B,H,S,D), lse (B,H,S));
    `causal`: query i attends to keys 0 .. i alone."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * _scale(q.shape[-1])
    if bias is not None:
        s = s + bias
    if causal:
        s = _causal(s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v) / denom
    return out, (m + torch.log(denom)).squeeze(-1)


def reference_attention_bf16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention in K2's bf16 mode: (out (B,H,S,D) bf16, lse (B,H,S) f32).

    The Pallas kernel's `mm_dtype=bfloat16` arithmetic: bf16 q, k, v and bias,
    both products with f32 sums, the softmax in f32 with each row's max over
    all S, P rounded to bf16 for P V, out = O / sum(P) rounded to bf16.
    `causal` (the causal mode's twin): keys after their query at -inf.
    """
    qf, kf, vf = (t.to(torch.bfloat16).float() for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * _scale(q.shape[-1])
    s = s + bias.to(torch.bfloat16).float()
    if causal:
        s = _causal(s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf)
    return (o / denom).to(torch.bfloat16), (m + torch.log(denom)).squeeze(-1)


def attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward with the kernels' formulas: (dq, dk, dv, dbias).

    P is recomputed from lse, exp(s - lse), as K3 and K4 do (not autograd),
    delta = rowsum(dO * O); dbias is (B, 1, 1, S), dS summed over heads and
    query rows.
    """
    scale = _scale(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    delta = (do * out).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return dq, dk, dv, ds.sum(dim=(1, 2), keepdim=True)


def attention_bwd_reference_bf16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward in K3/K4's bf16 mode: (dq, dk, dv) bf16, dbias in the
    bias's dtype.

    The Pallas kernels' `mm_dtype=bfloat16` arithmetic on bf16 q, k, v, out
    and dO, bf16 bias and f32 lse: s = q k^T (f32 sums) * scale + bias and
    dP = dO v^T in f32, P = exp(s - lse), delta = rowsum(dO * O) in f32,
    dS = P (dP - delta); dS and P rounded to bf16 before dQ = dS k * scale,
    dK = dS^T q * scale and dV = P^T dO, which sum in f32 and round to bf16
    once; dbias sums the unrounded dS over heads and query rows in f32.
    """
    qf, kf, vf, of, dof = (t.to(torch.bfloat16).float() for t in (q, k, v, out, do))
    scale = _scale(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale + bias.float()
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    pb, dsb = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dsb, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pb, dof)
    bf16 = torch.bfloat16
    return (dq.to(bf16), dk.to(bf16), dv.to(bf16),
            ds.sum(dim=(1, 2), keepdim=True).to(bias.dtype))


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


def _bf16_entry(name: str):
    fn = getattr(_build.load("flash_attention_fwd_bf16"), name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _bf16_kernel():
    global _bf16_lib
    if _bf16_lib is None:
        _bf16_lib = _bf16_entry("ufnd_flash_attention_fwd_bf16")
    return _bf16_lib


def _bf16_causal_kernel():
    global _bf16_causal_lib
    if _bf16_causal_lib is None:
        _bf16_causal_lib = _bf16_entry("ufnd_flash_attention_fwd_bf16_causal")
    return _bf16_causal_lib


def _bf16_smem(dim: int) -> int:
    """The bf16 forward kernel's dynamic shared memory at head width `dim`
    (bytes; builds the library)."""
    fn = _build.load("flash_attention_fwd_bf16").ufnd_flash_attention_fwd_bf16_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(dim)


def _bwd_kernel():
    global _bwd_lib, _bwd_block_keys
    if _bwd_lib is None:
        lib = _build.load("flash_attention_bwd")
        fn = lib.ufnd_flash_attention_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        keys = lib.ufnd_flash_attention_bwd_block_keys
        keys.argtypes, keys.restype = [ctypes.c_int], ctypes.c_int
        _bwd_lib, _bwd_block_keys = fn, keys
    return _bwd_lib


def _bwd_bf16_kernel():
    global _bwd_bf16_lib, _bwd_bf16_block_keys
    if _bwd_bf16_lib is None:
        lib = _build.load("flash_attention_bwd_bf16")
        fn = lib.ufnd_flash_attention_bwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
            ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        keys = lib.ufnd_flash_attention_bwd_bf16_block_keys
        keys.argtypes, keys.restype = [ctypes.c_int], ctypes.c_int
        _bwd_bf16_lib, _bwd_bf16_block_keys = fn, keys
    return _bwd_bf16_lib


def _check_lse(q, lse) -> None:
    b, h, s, _ = q.shape
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be contiguous f32 {(b, h, s)}, got {tuple(lse.shape)}")


def _check(q, k, v, bias, *grads, dtype=torch.float32) -> None:
    """Raise on anything the kernels do not take; `grads` are the backward's
    extra (B, H, S, D) operands (out, dO); every operand must be `dtype`."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D), got shape {tuple(q.shape)}")
    b, h, s, d = q.shape
    if any(t.shape != q.shape for t in (k, v, *grads)):
        raise ValueError(
            f"q, k, v (and out, dO) shapes differ: "
            f"{[tuple(t.shape) for t in (q, k, v, *grads)]}"
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
    named = [("q", q), ("k", k), ("v", v), ("bias", bias)]
    named += [(f"grad operand {i}", t) for i, t in enumerate(grads)]
    for name, t in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads, TMA)")


def _launch_fwd(fn, name: str, q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a forward kernel's C entry `fn` on the current stream: (out in
    q's dtype, lse f32); raises when the launch fails."""
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, h, s, d, _scale(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err < 0:  # the bf16 kernel's host side: a TMA tensor map it could not encode
        raise RuntimeError(
            f"{name}: tensor map encode failed (code {err}: -1 no cuTensorMapEncodeTiled, "
            f"else -1000 - CUresult) at shape {(b, h, s, d)}"
        )
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} at shape {(b, h, s, d)}"
        )
    return out, lse


def _default_bias(q: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if bias is not None:
        return bias
    return torch.zeros((q.shape[0], 1, 1, q.shape[2]), dtype=q.dtype, device=q.device)


def _fwd_cuda(q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA implementation of `ufnd::flash_attention_fwd`: K2."""
    _check(q, k, v, bias)
    out, lse = _launch_fwd(_kernel(), "flash_attention_fwd", q, k, v, bias)
    global launches
    with _COUNT_LOCK:
        launches += 1
    return out, lse


def _fwd_bf16_cuda(q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA implementation of `ufnd::flash_attention_fwd_bf16`: K2's bf16 mode."""
    _check(q, k, v, bias, dtype=torch.bfloat16)
    out, lse = _launch_fwd(_bf16_kernel(), "flash_attention_fwd_bf16", q, k, v, bias)
    global bf16_launches
    with _COUNT_LOCK:
        bf16_launches += 1
    return out, lse


def _fwd_bf16_causal_cuda(q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA implementation of `ufnd::flash_attention_fwd_bf16_causal`."""
    _check(q, k, v, bias, dtype=torch.bfloat16)
    out, lse = _launch_fwd(_bf16_causal_kernel(), "flash_attention_fwd_bf16_causal",
                           q, k, v, bias)
    global bf16_causal_launches
    with _COUNT_LOCK:
        bf16_causal_launches += 1
    return out, lse


def _reference_attention_bf16_causal(q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    return reference_attention_bf16(q, k, v, bias, causal=True)


def _fwd_fake(q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shapes and dtypes of both forward ops: out like q, lse (B, H, S) f32."""
    b, h, s, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


def _fwd_setup_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs, *output)


def _fwd_backward(ctx, dout, _dlse):
    """The gradient of both forward ops: the fused K3 + K4 kernel, in its
    bf16 mode for bf16 q (its plain version on the CPU). lse is an
    auxiliary output: its gradient is not propagated."""
    q, k, v, bias, out, lse = ctx.saved_tensors
    bwd = flash_attention_bwd_bf16 if q.dtype == torch.bfloat16 else flash_attention_bwd
    return bwd(q, k, v, bias, out, lse, dout.contiguous(), with_dbias=ctx.needs_input_grad[3])


def _register_forward_op(name: str, plain, cuda,
                         backward: bool = True) -> "torch._library.custom_ops.CustomOpDef":
    """`ufnd::<name>(q, k, v, bias) -> (out, lse)` as a torch.library custom
    op: `plain` on the CPU, `cuda` on a GPU, a fake implementation for
    tracing (torch.export), and (`backward`) the fused backward as its
    gradient."""

    def cpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return plain(q, k, v, bias)

    op = torch.library.custom_op(f"ufnd::{name}", cpu, mutates_args=(), device_types="cpu")
    op.register_kernel("cuda")(cuda)
    op.register_fake(_fwd_fake)
    if backward:
        op.register_autograd(_fwd_backward, setup_context=_fwd_setup_context)
    return op


fwd_op = _register_forward_op("flash_attention_fwd", reference_attention, _fwd_cuda)
fwd_bf16_op = _register_forward_op("flash_attention_fwd_bf16", reference_attention_bf16,
                                   _fwd_bf16_cuda)
fwd_bf16_causal_op = _register_forward_op("flash_attention_fwd_bf16_causal",
                                          _reference_attention_bf16_causal,
                                          _fwd_bf16_causal_cuda, backward=False)


def _forward(op, q, k, v, bias) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return op(q, k, v, _default_bias(q, bias))


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B,H,S,D), lse (B,H,S) f32) of softmax(q k^T / sqrt(D) + bias) v.

    q, k, v: (B, H, S, D) float32, D in HEAD_DIMS; bias: (B, 1, 1, S)
    float32 additive mask (0 / NEG_INF), None for no mask. Calls the custom
    op `ufnd::flash_attention_fwd`: on a CUDA tensor it launches the kernel
    on the current stream and adds one to `launches`, and raises on a
    shape, dtype, layout or launch it cannot take; on a CPU tensor it
    returns `reference_attention`.
    """
    return _forward(fwd_op, q, k, v, bias)


def flash_attention_fwd_bf16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's bf16 mode: (out (B,H,S,D) bf16, lse (B,H,S) f32).

    q, k, v: (B, H, S, D) bfloat16, D in HEAD_DIMS; bias: (B, 1, 1, S)
    bfloat16 additive mask (`padding_bias(mask, torch.bfloat16)`), None for
    no mask. Calls the custom op `ufnd::flash_attention_fwd_bf16`: on a CUDA
    tensor it launches `csrc/flash_attention_fwd_bf16.cu` on the current
    stream and adds one to `bf16_launches`, and raises on a shape, dtype,
    layout or launch it cannot take; on a CPU tensor it returns
    `reference_attention_bf16`.
    """
    return _forward(fwd_bf16_op, q, k, v, bias)


def flash_attention_fwd_bf16_causal(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2-bf16's causal mode: query i attends to keys 0 .. i (and the bias).

    Operands and outputs as `flash_attention_fwd_bf16`. Calls the custom op
    `ufnd::flash_attention_fwd_bf16_causal`: on a CUDA tensor it launches
    the kernel's causal instantiation and adds one to
    `bf16_causal_launches`; on a CPU tensor it returns
    `reference_attention_bf16(..., causal=True)`. Forward only.
    """
    return _forward(fwd_bf16_causal_op, q, k, v, bias)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    with_dbias: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dq, dk, dv, dbias) of attention, given the forward's out and lse.

    Same operands as `flash_attention_fwd` plus out and dO (B, H, S, D) and
    lse (B, H, S), all float32. A CUDA call launches the fused backward
    once on the current stream (delta = rowsum(dO * O) is computed in it)
    and adds one to `bwd_launches`; it raises on a shape, dtype, layout or
    launch it cannot take. dbias (B, 1, 1, S) is the kernel's per-(b, h)
    partials summed over heads; when S exceeds the kernel's key block, dq
    is its per-key-block partials summed; both sums are torch reductions
    in a fixed order, so two calls give the same bits. `with_dbias=False`
    skips dbias and returns None. A CPU call returns
    `attention_bwd_reference`.
    """
    if q.device.type == "cpu":
        dq, dk, dv, dbias = attention_bwd_reference(q, k, v, bias, out, lse, do)
        return dq, dk, dv, dbias if with_dbias else None
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    _check(q, k, v, bias, out, do)
    _check_lse(q, lse)
    b, h, s, d = q.shape
    fn = _bwd_kernel()
    key_blocks = -(-s // _bwd_block_keys(d))
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    # dq, or one dq slab per key block when S spans several
    dq = torch.empty((key_blocks, *q.shape) if key_blocks > 1 else q.shape,
                     dtype=torch.float32, device=q.device)
    part = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_dbias else None
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            part.data_ptr() if part is not None else None,
            b, h, s, d, _scale(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: cudaError {err} "
            f"at shape {(b, h, s, d)}"
        )
    global bwd_launches
    with _COUNT_LOCK:
        bwd_launches += 1
    if key_blocks > 1:
        dq = dq.sum(dim=0)
    dbias = part.sum(dim=1).view(b, 1, 1, s) if part is not None else None
    return dq, dk, dv, dbias


def flash_attention_bwd_bf16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    with_dbias: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K3/K4's bf16 mode: (dq, dk, dv) bf16 and dbias in the bias's dtype.

    Same operands as `flash_attention_fwd_bf16` plus out and dO (B, H, S, D)
    bf16 and lse (B, H, S) f32. A CUDA call launches
    `csrc/flash_attention_bwd_bf16.cu` once on the current stream (delta is
    computed in it) and adds one to `bwd_bf16_launches`; it raises on a
    shape, dtype, layout or launch it cannot take. When S exceeds the
    kernel's key block, dq is its per-key-block f32 partials summed and
    then rounded to bf16 once; dbias (B, 1, 1, S) is the f32 per-(b, h)
    partials summed over heads, then cast to the bias's dtype; both sums
    are torch reductions in a fixed order, so two calls give the same
    bits. `with_dbias=False` skips dbias and returns None. A CPU call
    returns `attention_bwd_reference_bf16`.
    """
    if q.device.type == "cpu":
        dq, dk, dv, dbias = attention_bwd_reference_bf16(q, k, v, bias, out, lse, do)
        return dq, dk, dv, dbias if with_dbias else None
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    _check(q, k, v, bias, out, do, dtype=torch.bfloat16)
    _check_lse(q, lse)
    b, h, s, d = q.shape
    fn = _bwd_bf16_kernel()
    key_blocks = -(-s // _bwd_bf16_block_keys(d))
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    # dq in bf16, or one f32 dq slab per key block when S spans several
    dq = (torch.empty((key_blocks, *q.shape), dtype=torch.float32, device=q.device)
          if key_blocks > 1 else torch.empty_like(q))
    part = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_dbias else None
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dq.data_ptr() if key_blocks == 1 else None,
            dq.data_ptr() if key_blocks > 1 else None,
            dk.data_ptr(), dv.data_ptr(),
            part.data_ptr() if part is not None else None,
            b, h, s, d, _scale(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd_bf16 kernel launch failed: cudaError {err} "
            f"at shape {(b, h, s, d)}"
        )
    global bwd_bf16_launches
    with _COUNT_LOCK:
        bwd_bf16_launches += 1
    if key_blocks > 1:
        dq = dq.sum(dim=0).to(torch.bfloat16)
    dbias = part.sum(dim=1).view(b, 1, 1, s).to(bias.dtype) if part is not None else None
    return dq, dk, dv, dbias


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias) v, differentiable; (B, H, S, D).

    The entry the text tower calls, in serving, in training and inside an
    exported scoring program alike: the forward op (K2, or its bf16 mode
    for bf16 q, k, v and bias) on every path, its registered gradient the
    fused K3 + K4 kernel. On a CPU tensor both run their plain versions.
    bias (B, 1, 1, S) gets a gradient only when it requires one (the
    trainer's mask bias does not).
    """
    fwd = flash_attention_fwd_bf16 if q.dtype == torch.bfloat16 else flash_attention_fwd
    return fwd(q, k, v, bias)[0]


def padding_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S) 1/0 validity mask -> additive (B, 1, 1, S) bias in `dtype`
    (`(1 - mask) * NEG_INF` computed in `dtype`: -1e9 rounds to
    -998244352 in bf16, as in the JAX package)."""
    return ((1.0 - mask.to(dtype)) * NEG_INF)[:, None, None, :]
