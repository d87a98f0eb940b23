"""Pipeline parallelism for the text tower: a GPipe schedule over a `pipe`
group (counterpart of `ultrafnd_git_tpu/parallel/pipeline.py`:
`pipeline_blocks` `:58-206`, `pipelined_tower_apply` `:209-294`; its
`stack_block_params` / `unstack_block_params` `:38-55` have no
counterpart: they stack the blocks' parameters for JAX's scan, and the
stages here run the tower's own block modules).

With S stages and M microbatches the schedule runs T = M + S - 1 ticks; at
tick t stage s computes microbatch t - s with its D / S consecutive
blocks (the tower's own `EncoderBlock` modules), stage 0 ingests
microbatch t and the last stage emits microbatch t - S + 1. After each
tick but the last the activations hop from stage s to s + 1
(`collectives.ppermute`); the padding mask does not travel, every rank
holds all of it. The last stage's emitted microbatches are summed to every
rank of the group at the end (`collectives.reduce_from`: the other stages
hold zeros, so the sum is exact). The embedding and the tail (ln_final,
the pooling) are replicated, as in JAX.

Every rank runs the hop on every tick, fill and drain ticks included,
and selects with `torch.where` (ingest at stage 0, emit at the last stage)
instead of branching on its stage, so every hop's output reaches the
result on every rank. So every rank calls the same collectives in the
same order, forward and backward (a hop whose output some rank did not
use would skip its backward there and hang the group). A stage runs its
blocks only on the M ticks that hold one of its microbatches; on the
others it passes what it holds (zeros, or a clamped microbatch) on
unchanged. A block's own collectives (tensor parallelism) stay in step:
a `model` group lies within one stage.

Every rank holds every block's parameters; the blocks of the other
stages and, but on stage 0, the embedding get zero gradients, so the
trainer sums those leaves over the group (not ln_final, whose gradient
every rank holds whole). Training mode (`gen`): every block's two masks
are drawn for the rank's rows before the schedule, in the order the plain
tower draws them; each stage keeps its own blocks' masks and cuts each
microbatch's rows, so the step applies a one-device step's masks and
leaves the generator where that step does. `remat_tower` has no effect
here, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ultrafnd_git_tpu_torch.models.dropout import Gen
from ultrafnd_git_tpu_torch.parallel.collectives import Shard, ppermute, reduce_from


def pipeline_blocks(blocks: Sequence[torch.nn.Module], x: torch.Tensor, mask: torch.Tensor,
                    pipe: Shard, microbatches: Optional[int] = None,
                    data: Optional[Shard] = None, gen: Gen = None) -> torch.Tensor:
    """The D `blocks` applied in turn to `x` (B, L, W) under the GPipe
    schedule on `pipe` (D % S == 0; M = `microbatches`, default S). `x` and
    `mask` (B, L) are this rank's rows; with `data` (the data axes' Shard)
    they are 1 / dp of the global batch, and the divisibility checks are
    JAX's on the global one. Returns (B, L, W), the same on every rank of
    `pipe`. Every rank of `pipe` must call it."""
    S, s = pipe.size, pipe.rank
    depth = len(blocks)
    if depth % S:
        raise ValueError(f"depth={depth} not divisible by stages={S}")
    M = int(microbatches or S)
    dp = data.size if data is not None else 1
    B = x.shape[0] * dp
    if B % M:
        raise ValueError(f"batch={B} not divisible by microbatches={M}")
    if M % S:
        raise ValueError(
            f"microbatches={M} not divisible by stages={S} (the closing "
            "reduce_scatter tiles the microbatch axis over stages)"
        )
    mb = B // M
    if data is not None and mb % dp:
        raise ValueError(f"microbatch rows {mb} not divisible by data={dp}")
    rows = mb // dp  # this rank's rows of a microbatch
    per_stage = depth // S
    drops = [blk.draw_masks(x, gen) for blk in blocks]  # the plain tower's draw order
    own = range(s * per_stage, (s + 1) * per_stage)
    x_mb = x.reshape(M, rows, *x.shape[1:])
    m_mb = mask.reshape(M, rows, *mask.shape[1:])
    first = torch.tensor(s == 0, device=x.device)
    yes, no = torch.tensor(True, device=x.device), torch.tensor(False, device=x.device)
    act = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(M)]
    hop = [(i, i + 1) for i in range(S - 1)]  # no wraparound: stage 0 gets zeros
    ticks = M + S - 1
    for t in range(ticks):
        act = torch.where(first, x_mb[min(t, M - 1)], act)
        j = t - s  # the microbatch this stage holds, on M of the ticks
        y = act
        if 0 <= j < M:
            cut = slice(j * rows, (j + 1) * rows)
            for b in own:
                da, dm = drops[b]
                y = blocks[b].body(y, m_mb[j], None if da is None else da[cut],
                                   None if dm is None else dm[cut])
        k = min(max(t - (S - 1), 0), M - 1)
        outs[k] = torch.where(yes if s == S - 1 and t >= S - 1 else no, y, outs[k])
        if t < ticks - 1:
            act = ppermute(y, pipe, hop)
    return reduce_from(torch.cat(outs), pipe)


def pipelined_tower_apply(tower, ids: torch.Tensor, mask: torch.Tensor, pipe: Shard,
                          microbatches: Optional[int] = None, data: Optional[Shard] = None,
                          gen: Gen = None) -> torch.Tensor:
    """`tower(ids, mask, gen)` (a dense `TextTransformer`) with its blocks
    under `pipeline_blocks`; the embedding and the tail replicated. `ids`
    and `mask` (B, L) are this rank's rows; returns the pooled (B, width),
    the same on every rank of `pipe`."""
    x = tower.tok_embed(ids)
    if tower.dtype is not None:
        x = x.to(tower.dtype)
    x = tower.ln_embed(x + tower.pos_embed[:, : ids.shape[1]].to(x.dtype))
    x = pipeline_blocks(list(tower.blocks), x, mask, pipe, microbatches, data, gen)
    x = tower.ln_final(x)
    m = mask[..., None]
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return pooled / (pooled.norm(dim=-1, keepdim=True) + 1e-9)
