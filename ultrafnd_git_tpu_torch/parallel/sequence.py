"""Sequence parallelism for the text tower: ring attention over an `sp`
group (counterpart of `ultrafnd_git_tpu/parallel/sequence.py:60-163`,
`sequence_parallel_tower_apply`).

Each rank of the sp group holds its (B, L/sp, W) slice of the activations:
the embedding, the positional rows of its slice (from pos0 = index * L/sp),
every layer norm, the QKV and output projections and the MLP run on the
slice with no traffic. Attention is the one op that mixes positions; it
runs as the ring (`kernels/ring_attention.py`). The blocks are the tower's
own `EncoderBlock` modules, called with `ring=`; nothing of the block is
written twice. `ln_final` runs on the slice, and the pooling is a masked
sum per slice, then one sum of numerator and denominator over the group
(`collectives.reduce_from`), so the pooled, L2-normalised (B, W) output
is the same on every rank of the group.

Training mode (`gen`, a generator or the trainer's `ShardedGenerator`):
each block's two masks are drawn for the whole (B, L, W) activation, as
the plain tower draws them, and cut to this rank's positions
(`models/dropout.seq_shard`), so an sp step applies the masks of a
one-device step and leaves the generator where that step does. Gradients
reach every tower leaf through the ring and the pooling sum: each rank
holds its slice's part of each leaf's gradient, and the trainer sums
them over the group. `remat_tower` has no effect here, as in JAX, whose
shard_map body applies the blocks without remat.
"""
from __future__ import annotations

import torch

from ultrafnd_git_tpu_torch.models.dropout import Gen, seq_shard
from ultrafnd_git_tpu_torch.parallel.collectives import Shard, reduce_from


def sequence_parallel_tower_apply(tower, ids: torch.Tensor, mask: torch.Tensor, sp: Shard,
                                  gen: Gen = None) -> torch.Tensor:
    """`tower(ids, mask, gen)` (a dense `TextTransformer`) with the sequence
    split over the ranks of `sp`: `ids` and `mask` (B, L) are this rank's
    batch rows, whole along L; returns the pooled (B, width), the same on
    every rank of `sp`. ValueError when sp does not divide L (JAX's text).
    Every rank of `sp` must call it."""
    n, i = sp.size, sp.rank
    b, length = ids.shape
    if length % n:
        raise ValueError(f"seq len {length} not divisible by sp={n}")
    per = length // n
    cut = slice(i * per, (i + 1) * per)
    ids_loc, mask_loc = ids[:, cut], mask[:, cut]
    x = tower.tok_embed(ids_loc)
    if tower.dtype is not None:
        x = x.to(tower.dtype)
    x = tower.ln_embed(x + tower.pos_embed[:, cut].to(x.dtype))
    gen = seq_shard(gen, i, n)
    for block in tower.blocks:
        x = block.body(x, mask_loc, *block.draw_masks(x, gen), ring=sp)
    x = tower.ln_final(x)
    m = mask_loc[..., None]
    width = x.shape[-1]
    sums = reduce_from(torch.cat([(x * m).sum(dim=1), m.sum(dim=1)], dim=-1), sp)
    pooled = sums[:, :width] / sums[:, width:].clamp_min(1.0)
    return pooled / (pooled.norm(dim=-1, keepdim=True) + 1e-9)

