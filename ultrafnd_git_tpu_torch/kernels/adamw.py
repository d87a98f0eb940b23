"""AdamW with global-norm clipping: the hand-written Hopper kernel (K1) and
its plain twin.

`AdamW` is the plain version: the optax chain `clip_by_global_norm(c) ->
adamw(schedule, wd)` written as plain torch ops in optax's op order
(`adamw_reference_`, one call per parameter leaf). Only the tests and
chip_smoke.py build it, as the reference K1 is held to; the trainer always
uses `FusedAdamW`. `torch.optim.AdamW` is not used: its decoupled
`p *= 1 - lr * wd` and folded bias correction round differently.

`FusedAdamW` is the counterpart of `ultrafnd_git_tpu/kernels/adamw.py::
FusedAdamW` (kernel `_adamw_kernel`, K1): the same update, which on CUDA
tensors runs as ONE multi-tensor launch of `csrc/adamw.cu` per step over
every trainable leaf (a device table of p, m, v, g pointers), p, m and v
updated in place, bit-identical to `AdamW` on the same grads. On CPU
tensors it runs `adamw_reference_` per leaf. `launches` counts K1 launches
and nothing else. The device table (a row per leaf, then an entry per
4096-element block naming its leaf and chunk) is kept on the device and
sent again only when a pointer moves; `table_builds` counts those sends.
It and the host scalars reach the device through pinned buffers and
asynchronous copies, so a step enqueues K1 without waiting for its backward
to finish.

Both keep their state as {"count": int, "mu": {part: {name: tensor}},
"nu": ...} over the trainer's parameter dict {part: nn.Module}; parts named
in `frozen_subtrees` are left out of the global norm and left untouched
(torch's grad=None semantics, optax's multi_transform(set_to_zero)). The
scalars are computed once per step, exactly as the JAX `_scalars` does:
(1 - b) is a Python f64 rounded to f32, bias correction uses count + 1,
-schedule(count) is taken before the increment. The global norm is a torch
reduction outside the kernel, as it is outside the Pallas call. On a
tensor-parallel mesh (`shard_norm`) the norm is that of the logical
parameters: the split leaves' sums of squares are all-reduced over the
model axis; K1 itself is elementwise per leaf and runs on each rank's
shards, one launch a step on every rank.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ultrafnd_git_tpu_torch.kernels import _build
from ultrafnd_git_tpu_torch.parallel.collectives import Shard, all_reduce_
from ultrafnd_git_tpu_torch.utils.device import to_device
from ultrafnd_git_tpu_torch.utils.spans import span

launches = 0  # K1 launches since import (or since a caller reset it)
table_builds = 0  # device tables built and sent (a leaf's pointer moved)
_lib = None
_table = (None, None)  # ((device, rows), (device table, blocks)) of the last launch

Tensors = Dict[str, Dict[str, torch.Tensor]]


def adamw_reference_(
    p: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    scal: torch.Tensor,
) -> None:
    """One leaf's update in place, as separate torch ops in optax order.

    scal: the (16,) f32 scalar row of `AdamW.scalars`, on p's device (each
    slot stays a tensor, so every op is an elementwise kernel that rounds
    once, like the fused kernel's __f*_rn intrinsics).
    """
    gnorm, clip, b1, b2, eps, wd, neg_lr, bc1, bc2, has_clip, omb1, omb2 = scal[:12]
    g = torch.where(has_clip > 0, torch.where(gnorm < clip, g, (g / gnorm) * clip), g)
    m_new = omb1 * g + b1 * m
    v_new = omb2 * (g * g) + b2 * v
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    u = u + wd * p
    p.copy_(p + neg_lr * u)
    m.copy_(m_new)
    v.copy_(v_new)


def global_norm(grads: Iterable[torch.Tensor], split: Optional[List[bool]] = None,
                tp: Optional[Shard] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (optax.global_norm). On a
    tensor-parallel mesh, `split[i]` marks a leaf of which this rank holds
    a shard: its sum of squares is summed over `tp` (one all-reduce for
    all of them) before the total, so the norm is that of the logical
    parameters; a replicated leaf counts once."""
    sq = torch.stack([torch.sum(g * g) for g in grads])
    if tp is not None and any(split):
        flags = to_device(torch.tensor(split), sq.device)
        summed = all_reduce_(torch.where(flags, sq, torch.zeros_like(sq)), tp)
        sq = torch.where(flags, summed, sq)
    return torch.sqrt(sq.sum())


class AdamW:
    """clip_by_global_norm + AdamW + LR schedule in optax op order (plain)."""

    def __init__(
        self,
        schedule: Callable[[int], float],
        weight_decay: float,
        grad_clip: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        frozen_subtrees: Tuple[str, ...] = (),
    ):
        self.schedule = schedule
        self.weight_decay = float(weight_decay)
        self.grad_clip = float(grad_clip)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.frozen = frozenset(frozen_subtrees)
        self.split: frozenset = frozenset()  # (part, name) of the leaves split over tp
        self.tp: Optional[Shard] = None

    def shard_norm(self, split, tp: Shard) -> None:
        """Take the global norm over a tensor-parallel mesh: `split` names
        the (part, name) leaves of which each rank of `tp` holds a shard."""
        self.split, self.tp = frozenset(split), tp

    def init(self, params: Dict[str, nn.Module]) -> Dict[str, object]:
        zeros = lambda: {  # noqa: E731
            part: {n: torch.zeros_like(p) for n, p in mod.named_parameters()}
            for part, mod in params.items()
        }
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def scalars(self, grads: Tensors, count: int) -> torch.Tensor:
        """The (16,) f32 scalar row (slot layout of csrc/adamw.cu), on the
        grads' device: only gnorm is computed there, the rest on the host.
        Without a clip nothing reads gnorm, so its slot holds 0 and no norm
        is taken."""
        named = [(part, name, g) for part, d in grads.items() if part not in self.frozen
                 for name, g in d.items()]
        leaves = [g for _, _, g in named]
        f32 = np.float32
        host = np.array(
            [
                0.0,
                self.grad_clip,
                self.b1,
                self.b2,
                self.eps,
                self.weight_decay,
                -f32(self.schedule(count)),
                # optax bias_correction: 1 - decay ** (count + 1) in f32
                f32(1.0) - f32(self.b1) ** f32(count + 1),
                f32(1.0) - f32(self.b2) ** f32(count + 1),
                1.0 if self.grad_clip > 0 else 0.0,
                1 - self.b1,  # Python f64, then rounded, as optax's 1 - decay
                1 - self.b2,
                0.0, 0.0, 0.0, 0.0,
            ],
            dtype=np.float32,
        )
        if self.grad_clip <= 0:
            return to_device(torch.from_numpy(host), leaves[0].device)
        split = [(part, name) in self.split for part, name, _ in named]
        gnorm = global_norm(leaves, split, self.tp).to(torch.float32)
        host_t = to_device(torch.from_numpy(host[1:]), gnorm.device)
        return torch.cat([gnorm.reshape(1), host_t])

    def _leaves(self, params, state, grads) -> List[Tuple[torch.Tensor, ...]]:
        out = []
        for part, mod in params.items():
            if part in self.frozen:
                continue
            for name, p in mod.named_parameters():
                out.append((p.data, state["mu"][part][name],
                            state["nu"][part][name], grads[part][name]))
        return out

    def _update(self, leaves, scal: torch.Tensor) -> None:
        for p, m, v, g in leaves:
            adamw_reference_(p, m, v, g, scal)

    @torch.no_grad()
    def apply(self, params: Dict[str, nn.Module], state, grads: Tensors):
        """One optimizer step in place on params and state; returns state."""
        with span("optimizer.norm"):
            scal = self.scalars(grads, state["count"])
        with span("optimizer.k1"):
            self._update(self._leaves(params, state, grads), scal)
        state["count"] += 1
        return state


def block_entries(numels, chunk: int) -> np.ndarray:
    """K1's per-block entries, (leaf << 32) | chunk index, for leaves of
    these sizes: ceil(numel / chunk) blocks per leaf, in leaf order."""
    numel = np.asarray(numels, dtype=np.int64)
    chunks = -(-numel // chunk)
    first = np.cumsum(chunks) - chunks
    leaf = np.repeat(np.arange(len(numel), dtype=np.int64), chunks)
    return (leaf << 32) | (np.arange(chunks.sum(), dtype=np.int64) - first[leaf])


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("adamw")
        fn = lib.ufnd_adamw_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ufnd_adamw_chunk.restype = ctypes.c_int
        _lib = (fn, int(lib.ufnd_adamw_chunk()))
    return _lib


def fused_adamw_(leaves: List[Tuple[torch.Tensor, ...]], scal: torch.Tensor) -> None:
    """K1 over every (p, m, v, g) leaf in one launch (CUDA), or the plain
    update per leaf (CPU). Raises on a leaf or launch the kernel cannot take."""
    if not leaves:
        return
    dev = scal.device
    if dev.type == "cpu":
        for p, m, v, g in leaves:
            adamw_reference_(p, m, v, g, scal)
        return
    if dev.type != "cuda":
        raise ValueError(f"no AdamW kernel for device {dev}")
    fn, chunk = _kernel()
    rows = []  # flat (p, m, v, g, numel, aligned) per leaf
    for leaf in leaves:
        n = leaf[0].numel()
        for t in leaf:
            if (t.dtype != torch.float32 or t.device != dev or not t.is_contiguous()
                    or t.numel() != n):
                raise ValueError(
                    "AdamW kernel takes contiguous float32 CUDA leaves of one size "
                    f"on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device} "
                    f"(contiguous={t.is_contiguous()}) beside {tuple(leaf[0].shape)}"
                )
        ptrs = [t.data_ptr() for t in leaf]
        rows += (*ptrs, n, int(all(x % 16 == 0 for x in ptrs)))
    global _table, launches, table_builds
    if _table[0] != (dev, rows):  # p, m, v never move; grads mostly come back in place
        blocks = block_entries(rows[4::6], chunk)
        host = torch.from_numpy(np.concatenate([np.array(rows, dtype=np.int64), blocks]))
        _table = ((dev, rows), (to_device(host, dev), len(blocks)))
        table_builds += 1
    table, n_blocks = _table[1]
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), len(leaves), n_blocks, scal.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"AdamW kernel launch failed: cudaError {err}")
    launches += 1


class FusedAdamW(AdamW):
    """The same update as `AdamW`, as one K1 launch per step on CUDA."""

    def _update(self, leaves, scal: torch.Tensor) -> None:
        fused_adamw_(leaves, scal)
