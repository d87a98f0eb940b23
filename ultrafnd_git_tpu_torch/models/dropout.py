"""Dropout drawn from an explicit torch.Generator (training mode).

The JAX modules draw their masks from flax's 'dropout' rng stream; the
port's modules take a `torch.Generator` from the caller instead (None means
eval mode: no dropout). Same rule as `flax.linen.Dropout`: keep with
probability 1 - rate and scale kept values by 1 / (1 - rate). The masks are
not the JAX masks (the generators differ); tests compare with dropout off.

`draw_mask` and `apply_mask` are the two halves of `dropout`, for a caller
that must draw a mask before the computation it applies to (the tower's
rematerialised blocks: a recompute must apply the masks of the first pass).

On a mesh (`parallel/mesh.py`) each rank passes a `ShardedGenerator`: it
draws the mask of the global batch (every rank's generator is in the same
state) and keeps this rank's rows, and, between the two layers of a
tensor-parallel MLP pair (`cols`), this rank's columns, and, in the
sequence-parallel tower (`seq`, `parallel/sequence.py`), this rank's
positions along dim 1. So dp, tp and sp runs apply the masks a one-device
run applies. The pipelined tower (`parallel/pipeline.py`) draws every
block's masks for the rank's rows before its schedule, in the order the
plain tower draws them, and cuts each microbatch's rows from them. A site
whose tensor is not split by batch rows (the GCN's corpus hidden) takes
the plain generator.

This is the port's own rule, and stronger than the JAX package's: JAX's
sp and pp towers draw counter-mode masks keyed on (layer, global row,
global position) (`coord_dropout`), which match its coord-keyed plain
tower but not its flax-stream one; the port's sp and pp masks are the
masks of its own plain tower, and its generator ends a step where the
plain step leaves it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple, Union

import torch


@dataclass(frozen=True)
class ShardedGenerator:
    """A generator and this rank's part of every mask it draws: block
    `rows[0]` of `rows[1]` along dim 0, block `cols[0]` of `cols[1]` along
    the last dim, block `seq[0]` of `seq[1]` along dim 1."""

    gen: torch.Generator
    rows: Tuple[int, int] = (0, 1)
    cols: Tuple[int, int] = (0, 1)
    seq: Tuple[int, int] = (0, 1)

    def draw(self, like: torch.Tensor, keep: float) -> torch.Tensor:
        """This rank's part of the mask one device draws for the global
        tensor: drawn in `like`'s memory order (the draws fill memory in
        order, and `empty_like` keeps a permuted layout, such as the
        forest's per-tree logits have), then cut."""
        (r, nr), (c, nc), (q, nq) = self.rows, self.cols, self.seq
        shape = list(like.shape)
        shape[0] *= nr
        shape[-1] *= nc
        if nq > 1:
            shape[1] *= nq
        order = sorted(range(like.dim()), key=lambda d: -like.stride(d))
        full = like.new_empty([shape[d] for d in order])
        full = full.bernoulli_(keep, generator=self.gen).bool().permute(
            [order.index(d) for d in range(like.dim())])
        if nq > 1:
            full = full.narrow(1, q * like.shape[1], like.shape[1])
        return (full.narrow(0, r * like.shape[0], like.shape[0])
                .narrow(-1, c * like.shape[-1], like.shape[-1]))


Gen = Union[torch.Generator, ShardedGenerator, None]


def _part(gen: Gen, **part) -> Gen:
    """`gen` (a ShardedGenerator, or a plain one as the whole) drawing this
    rank's part `part` as well (None stays None: eval mode)."""
    if gen is None:
        return None
    if not isinstance(gen, ShardedGenerator):
        gen = ShardedGenerator(gen)
    return replace(gen, **part)


def column_shard(gen: Gen, index: int, parts: int) -> Gen:
    """`gen` drawing this rank's block `index` of `parts` along the last
    dim as well."""
    return _part(gen, cols=(index, parts))


def seq_shard(gen: Gen, index: int, parts: int) -> Gen:
    """`gen` drawing this rank's block `index` of `parts` along dim 1 as
    well."""
    return _part(gen, seq=(index, parts))


def draw_mask(like: torch.Tensor, rate: float, gen: Gen) -> Optional[torch.Tensor]:
    """The keep mask (bool, the shape of `like`) of one dropout site, drawn
    from `gen` as `dropout` draws it; None in eval mode."""
    if gen is None or rate <= 0.0:
        return None
    if isinstance(gen, ShardedGenerator):
        return gen.draw(like, 1.0 - rate)
    return torch.empty_like(like).bernoulli_(1.0 - rate, generator=gen).bool()


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """x scaled by 1 / (1 - rate) where `mask` keeps it, else 0 (x itself
    for a None mask)."""
    if mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, gen: Gen) -> torch.Tensor:
    """x with each element kept with probability 1 - rate, else zeroed."""
    return apply_mask(x, draw_mask(x, rate, gen), rate)
