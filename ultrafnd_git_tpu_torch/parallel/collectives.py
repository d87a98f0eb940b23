"""The collectives of the mesh layer (in JAX, XLA inserts these from the
sharding annotations; here they are explicit).

Only `all_reduce` is used, so one code path runs over NCCL, over gloo on
the CPU and over gloo with CUDA tensors (gloo has no all-gather for CUDA
tensors). A gather is "owner fills, all-reduce sums":
each rank writes the rows it owns into a zero buffer of the full size, and
the sum over ranks is the gathered array, exactly (every element has one
nonzero term).

`Shard` names one axis group of the mesh as this rank sees it (the group,
this rank's index in it, its size). The autograd functions are Megatron's
pair, `copy_to` (identity forward, all-reduce backward: a replicated input
entering column shards) and `reduce_from` (all-reduce forward, identity
backward: row-shard partial sums leaving), and `sum_across`, all-reduce
both ways, for a statistic summed over the data ranks whose every rank's
loss reads it (the switch-MoE balance terms).

`ppermute` is JAX's `lax.ppermute` (the ring's K/V hop and the pipeline's
stage hop) by the same rule: each rank writes its tensor into its
destination's slot of a zero buffer of `size` slots, one all-reduce sums
the buffer, and each rank reads its own slot (zeros where no rank sends to
it). Its backward is the inverse permutation, done the same way. This
moves `size` times the bytes of a point-to-point send, on every rank;
gloo has no send/recv for CUDA tensors, and one route serves NCCL, gloo
and the CPU alike.

`calls` counts the collectives launched since import (or since a caller
reset it), and nothing else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

calls = 0  # collectives (all-reduces) launched since import or a reset


@dataclass(frozen=True)
class Shard:
    """One axis group of the mesh from this rank: `group` (a torch.distributed
    process group), this rank's `rank` in it and its `size`."""

    group: Any
    rank: int
    size: int

    def __deepcopy__(self, memo):  # modules holding it are deep-copied; groups are not
        return self


def all_reduce_(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Sum `t` in place over the ranks of `shard`; returns `t`."""
    global calls
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=shard.group)
    calls += 1
    return t


def all_reduce_coalesced_(tensors: Sequence[torch.Tensor], *shards: Shard) -> None:
    """Sum each of `tensors` in place over each of `shards` in turn (a
    hierarchical sum: within one axis, then across the next), with one
    collective per dtype and shard, their elements packed into one flat
    buffer."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        if len(group) == 1 and group[0].is_contiguous():
            for shard in shards:
                all_reduce_(group[0], shard)
            continue
        flat = torch.cat([t.reshape(-1) for t in group])
        for shard in shards:
            all_reduce_(flat, shard)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset: offset + n].view_as(t))
            offset += n


def owner_gather(parts: List[torch.Tensor], starts: List[int], idx: torch.Tensor,
                 shard: Shard) -> List[torch.Tensor]:
    """Rows `idx` (global row ids, every rank the same) of arrays whose rows
    are split over `shard`: this rank holds `parts[i]`, rows
    [starts[i], starts[i] + len(parts[i])) of array i. Each rank fills the
    rows it owns into zeros of (len(idx), ...), one all-reduce a dtype sums
    them; every rank returns all len(idx) rows of each array."""
    outs = []
    for part, start in zip(parts, starts):
        local = idx - start
        own = (local >= 0) & (local < part.shape[0])
        rows = part[local.clamp(0, part.shape[0] - 1)]
        # a select, not a masked write: nothing waits for the device
        outs.append(torch.where(own.view(-1, *(1,) * (part.dim() - 1)), rows,
                                torch.zeros((), dtype=part.dtype, device=part.device)))
    all_reduce_coalesced_(outs, shard)
    return outs


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.shard), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return all_reduce_(x.contiguous().clone(), shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return all_reduce_(x.contiguous().clone(), shard)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.shard), None


def copy_to(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Identity forward, all-reduce over `shard` backward."""
    return _CopyTo.apply(x, shard)


def reduce_from(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """All-reduce over `shard` forward, identity backward."""
    return _ReduceFrom.apply(x, shard)


def sum_across(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """All-reduce over `shard` forward and backward: the sum of a value of
    every rank, where every rank's loss reads the sum."""
    return _SumAcross.apply(x, shard)


def _permuted(x: torch.Tensor, shard: Shard, perm: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """x of the rank that `perm` sends to this one (zeros when none does)."""
    buf = x.new_zeros((shard.size, *x.shape))
    dest = dict(perm).get(shard.rank)
    if dest is not None:
        buf[dest] = x
    return all_reduce_(buf, shard)[shard.rank]


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, perm):
        ctx.shard, ctx.inverse = shard, tuple((d, s) for s, d in perm)
        return _permuted(x, shard, perm)

    @staticmethod
    def backward(ctx, g):
        return _permuted(g.contiguous(), ctx.shard, ctx.inverse), None, None


def ppermute(x: torch.Tensor, shard: Shard, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """`lax.ppermute(x, axis, perm)` over the ranks of `shard`: rank `d`
    gets the `x` of rank `s` for each pair (s, d) of `perm`, zeros when no
    pair ends at it; the gradient goes back along the inverse pairs. Every
    rank of `shard` must call it (one all-reduce each way)."""
    return _Permute.apply(x, shard, tuple((int(s), int(d)) for s, d in perm))
