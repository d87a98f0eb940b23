"""Switch (top-1) mixture-of-experts FFN for the text tower.

Counterpart of `ultrafnd_git_tpu/models/moe.py:44-172` (`MoEFFN`,
`MoEEncoderBlock`); parameter names follow the Flax tree (`router`, and the
stacked expert arrays `w_in` (E, W, 4W), `b_in` (E, 1, 4W), `w_out` (E, 4W,
W), `b_out` (E, 1, W)).

Routing is the JAX module's: an f32 `Dense(W, E)` router whatever the
compute dtype, its softmax and argmax (first index on a tie), the gate (the
chosen probability), and a capacity C = ceil(T * capacity_factor / E) over
the T = B * S tokens in row-major (B, S) order. A token's slot is its rank
among the earlier tokens routed to its expert; tokens at slot >= C are
dropped (output 0, the residual passes them through). Padding positions are
routed too: the FFN never sees the mask. The aux loss is Switch's, balance
E * sum_e(frac_tokens_e * frac_probs_e) plus 1e-3 times the router z-loss.

The dispatch is in index form, not the (T, E, C) one-hot einsums of the
JAX module: each kept token is copied into its (e, c) row, the experts run
as two `torch.bmm` over E, and each token gathers its row of the output
scaled by its gate. Each one-hot sum has one nonzero term, so this is the
same function; at the training shape (T = 32768, E = 8, C = 5120) a (T, E,
C) f32 tensor would be 5.4 GB and each einsum five times the experts' own
FLOPs. The (e, c) slots are unique, so each backward scatter has one
contributor per row and the gradient does not depend on atomic order.
Dropped tokens go to one spare row past the E * C slots, which is cut off
before the experts.

On a data-parallel mesh (`dp`, the data axes' `Shard`, set by the
trainer) each rank routes its rows of the global batch as one device
routes the whole: C is the global batch's, a token's slot counts the
tokens of the lower ranks routed to its expert, and the aux loss is the
global batch's (`parallel/collectives.sum_across`, whose backward sums
every rank's gradient of it).

Expert parallelism (JAX `moe.py:167-183`, `expert_parallel_specs`):
`expert_parallel_(module, ep)` cuts the expert arrays (`EXPERT_LEAVES`)
of every `MoEFFN` in `module` along E to this rank's E / ep experts over
an `ep` `Shard`; the router and everything else stay whole. The routing
then runs on every rank over all tokens, as one device runs it; each rank
runs its experts on their (e, c) rows (the dispatched rows enter through
`copy_to`, so the gradient that reaches the tokens sums every rank's
experts), and the expert outputs are put back in E order by one
owner-fill all-reduce (`reduce_from`) before the gate-scaled gather. The
output and the aux loss equal the whole module's, and each rank's expert
gradients are its slice of the whole module's. JAX has no --ep flag and
the trainer takes none.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.models.dropout import apply_mask, draw_mask
from ultrafnd_git_tpu_torch.models.layers import Dense, LayerNorm
from ultrafnd_git_tpu_torch.models.transformer import LN_EPS, MultiHeadAttention, gelu
from ultrafnd_git_tpu_torch.parallel.collectives import Shard, copy_to, reduce_from, sum_across

EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out")  # MoEFFN's expert-stacked arrays


class MoEFFN(nn.Module):
    """Switch (top-1) MoE feed-forward: (B, S, W) -> ((B, S, W), aux)."""

    def __init__(self, width: int, num_experts: int = 8, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, dtype: Optional[torch.dtype] = None,
                 gelu: str = "tanh"):
        super().__init__()
        self.width, self.num_experts = width, num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.gelu = gelu
        hidden = mlp_ratio * width
        self.router = Dense(width, num_experts)  # f32 whatever the compute dtype
        self.w_in = nn.Parameter(torch.zeros(num_experts, width, hidden))
        self.b_in = nn.Parameter(torch.zeros(num_experts, 1, hidden))
        self.w_out = nn.Parameter(torch.zeros(num_experts, hidden, width))
        self.b_out = nn.Parameter(torch.zeros(num_experts, 1, width))
        self.dp = None  # the data axes' Shard on a mesh: route the global batch
        self.ep = None  # the ep Shard when the experts are cut (expert_parallel_)

    def capacity(self, tokens: int) -> int:
        """Slots per expert for `tokens` tokens (the JAX expression)."""
        return int(max(1, -(-tokens * self.capacity_factor // self.num_experts)))

    def route(self, x: torch.Tensor):
        """(logits (T, E) f32, probs, expert (T,), gate (T,), slot (T,)) of
        x (B, S, W); slot is the token's 0-based rank within its expert."""
        logits = self.router(x.reshape(-1, self.width).float())
        probs = torch.softmax(logits, dim=-1)
        expert = probs.argmax(dim=-1)
        gate = probs.gather(1, expert[:, None])[:, 0]
        # the rank among earlier tokens of the same expert (JAX's cumsum over
        # the token axis), scanned along the last axis of an (E, T) int32
        # copy: on a GPU a scan down the long axis of (T, E) is slow
        onehot = F.one_hot(expert, self.num_experts).t().to(torch.int32)
        ranks = onehot.cumsum(dim=1, dtype=torch.int32)
        slot = ranks.gather(0, expert[None])[0].long() - 1
        return logits, probs, expert, gate, slot

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, w = x.shape
        e, t = self.num_experts, b * s
        dp = self.dp
        t_all = t * (dp.size if dp is not None else 1)
        cap = self.capacity(t_all)
        logits, probs, expert, gate, slot = self.route(x)
        lse2 = torch.logsumexp(logits, dim=-1).square()
        if dp is None:
            frac_tokens = F.one_hot(expert, e).float().mean(dim=0)
            frac_probs = probs.mean(dim=0)
            z = lse2.mean()
        else:
            # the global batch's routing: one all-reduce of each rank's
            # expert counts (in its own row), its prob sums and its z sum
            counts = probs.new_zeros(dp.size, e)
            counts[dp.rank] = F.one_hot(expert, e).sum(dim=0).float()
            stats = sum_across(torch.cat([counts.reshape(-1), probs.sum(dim=0),
                                          lse2.sum().reshape(1)]), dp)
            counts = stats[: dp.size * e].detach().view(dp.size, e)
            # a token's slot counts the tokens of lower ranks before it
            slot = slot + counts[: dp.rank].sum(dim=0).long()[expert]
            frac_tokens = counts.sum(dim=0) / t_all
            frac_probs = stats[dp.size * e: dp.size * e + e] / t_all
            z = stats[-1] / t_all
        keep = slot < cap
        dest = torch.where(keep, expert * cap + slot, e * cap)  # e * cap: the spare row
        cd = self.dtype or x.dtype
        xt = x.reshape(t, w).to(cd)
        xe = xt.new_zeros(e * cap + 1, w).index_copy(0, dest, xt)[: e * cap].view(e, cap, w)
        ep = self.ep
        if ep is not None:  # this rank's experts' rows
            lo = ep.rank * self.w_in.shape[0]
            xe = copy_to(xe, ep)[lo: lo + self.w_in.shape[0]]
        h = gelu(torch.bmm(xe, self.w_in.to(cd)) + self.b_in.to(cd), self.gelu)
        ye = torch.bmm(h, self.w_out.to(cd)) + self.b_out.to(cd)
        if ep is not None:  # every expert's rows, in E order, on every rank
            pad = [ye.new_zeros(lo, cap, w), ye, ye.new_zeros(e - lo - ye.shape[0], cap, w)]
            ye = reduce_from(torch.cat(pad), ep)
        ye = torch.cat([ye.reshape(e * cap, w), ye.new_zeros(1, w)])
        yt = ye[dest] * torch.where(keep, gate, 0.0).to(cd)[:, None]

        balance = e * (frac_tokens * frac_probs).sum()
        return yt.view(b, s, w).to(x.dtype), balance + 1e-3 * z


class MoEEncoderBlock(nn.Module):
    """`EncoderBlock` with the dense MLP swapped for `MoEFFN`: the same
    attention, layer-norm, residual and dropout sites; returns (x, aux)."""

    def __init__(self, width: int, heads: int, num_experts: int = 8, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, gelu: str = "tanh", dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.ln1 = LayerNorm(width, LN_EPS, dtype)
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.ln2 = LayerNorm(width, LN_EPS, dtype)
        self.moe = MoEFFN(width, num_experts, mlp_ratio, capacity_factor, dtype, gelu)

    def draw_masks(self, x: torch.Tensor, gen: Optional[torch.Generator]):
        """The keep masks of the two dropout sites (see EncoderBlock)."""
        return draw_mask(x, self.dropout, gen), draw_mask(x, self.dropout, gen)

    def body(self, x: torch.Tensor, mask: torch.Tensor, drop_attn=None, drop_ffn=None):
        x = x + apply_mask(self.attn(self.ln1(x), mask), drop_attn, self.dropout)
        y, aux = self.moe(self.ln2(x))
        return x + apply_mask(y, drop_ffn, self.dropout), aux

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.body(x, mask, *self.draw_masks(x, gen))


def expert_parallel_(module: nn.Module, ep: Shard) -> nn.Module:
    """Cut the expert arrays of every `MoEFFN` in `module` (in place) to this
    rank's block of E / ep experts along E, and hand each its `ep` Shard;
    ValueError when ep does not divide E. Returns `module`."""
    for mod in module.modules():
        if not isinstance(mod, MoEFFN):
            continue
        if mod.num_experts % ep.size:
            raise ValueError(f"{mod.num_experts} experts do not split over ep={ep.size}")
        per = mod.num_experts // ep.size
        for name in EXPERT_LEAVES:
            full = getattr(mod, name)
            setattr(mod, name, nn.Parameter(full.data[ep.rank * per: (ep.rank + 1) * per].clone(),
                                            requires_grad=full.requires_grad))
        mod.ep = ep
    return module
