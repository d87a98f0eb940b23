"""Text tower over the flash-attention kernels (dense MLP blocks).

Counterpart of `ultrafnd_git_tpu/models/transformer.py`: the hash
tokenizer, `MultiHeadAttention`, `EncoderBlock` and `TextTransformer`
(ids (B, L) -> mean-pooled, L2-normalised (B, width)). Parameter names
follow the Flax tree (`utils/transfer.py` maps one onto the other). Every
attention call goes through `kernels.flash_attention`, whatever S is: on a
CUDA tensor its forward is K2 and its backward K3 + K4. Training mode
(a `torch.Generator` passed as `gen`) drops 0.1 at the two sites of each
block, after attention and after `mlp_out`, as the JAX block does; nothing
inside attention is dropped. A block draws its two masks before it computes
anything (the order the plain block would draw them in, since nothing
between the two sites draws), so `remat=True` (JAX's `nn.remat` of each
block, here `torch.utils.checkpoint` without reentrance) hands the same
masks to the first pass and to the recompute: remat on and off give the
same bits, and the generator ends in the same state. Under remat K2 runs
twice per block and step (the recompute). `moe_experts > 0` swaps each
block for `models/moe.MoEEncoderBlock` (switch top-1 FFN);
`return_aux=True` then also returns the Switch aux loss, the mean over
blocks. Ring attention and coord dropout are not ported yet (ROADMAP.md):
the trainer raises for `sp` and `pp`.

`dtype=torch.bfloat16` is the JAX tower's `dtype=jnp.bfloat16` (serving's
bf16 lever and the trainer's `bf16_compute`; params stay f32): the
embedding rows, every Dense and the block layer norms' outputs are bf16
(`models/layers.py` mirrors Flax's casts), the padding bias is bf16,
attention runs on K2's bf16 mode and its backward on K3/K4's, and the
final layer norm and the pooling are f32. The bf16 tower is differentiable
(gradients reach the f32 params through the casts); a fully masked record
keeps finite gradients (its rows' P is 1 per key in the backward, and the
pooling gives them no gradient).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ultrafnd_git_tpu_torch.kernels.flash_attention import (
    flash_attention,
    padding_bias,
)
from ultrafnd_git_tpu_torch.models.dropout import apply_mask, draw_mask
from ultrafnd_git_tpu_torch.models.layers import Dense, LayerNorm
from ultrafnd_git_tpu_torch.ops.hashing import basis_for_salt, fnv1a_64

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon (torch defaults to 1e-5)


def _hash_tokens(text: str) -> list:
    """Whitespace tokens, with CJK runs broken into single characters."""
    out = []
    for tok in (text or "").split():
        run = ""
        for ch in tok:
            if "一" <= ch <= "鿿":
                if run:
                    out.append(run)
                    run = ""
                out.append(ch)
            else:
                run += ch
        if run:
            out.append(run)
    return out


def hash_tokenize_batch(
    texts: Sequence[str],
    max_len: int = 256,
    vocab_size: int = 32768,
    salt: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stable hash ids (N, L) int32 and mask (N, L) f32; id 0 is padding.

    `salt=None` uses the process-wide draw (`ops.hashing.set_hash_salt`),
    an explicit salt pins its own draw without touching process state.
    """
    basis = None if salt is None else basis_for_salt(salt)
    ids = np.zeros((len(texts), max_len), dtype=np.int32)
    mask = np.zeros((len(texts), max_len), dtype=np.float32)
    for i, text in enumerate(texts):
        toks = _hash_tokens(text)[:max_len]
        for j, t in enumerate(toks):
            ids[i, j] = 1 + (fnv1a_64(t, basis) % (vocab_size - 1))
        mask[i, : len(toks)] = 1.0
    return ids, mask


def gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    """`"exact"` (erf) or `"tanh"` GELU, as the checkpoint's tower_gelu says."""
    return F.gelu(x, approximate="none" if kind == "exact" else "tanh")


class MultiHeadAttention(nn.Module):
    """qkv Dense -> split in three -> (B, H, S, D) -> flash kernel -> out."""

    def __init__(self, width: int, heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if width % heads:
            raise ValueError(f"width={width} not divisible by heads={heads}")
        self.width, self.heads = width, heads
        self.qkv = Dense(width, 3 * width, dtype)
        self.out = Dense(width, width, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        d = self.width // self.heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)  # jnp.split(qkv, 3, -1)

        def heads_first(t):
            return t.reshape(b, s, self.heads, d).transpose(1, 2).contiguous()

        o = flash_attention(
            heads_first(q), heads_first(k), heads_first(v), padding_bias(mask, x.dtype)
        )  # (B, H, S, D)
        return self.out(o.transpose(1, 2).reshape(b, s, self.width))


class EncoderBlock(nn.Module):
    """Pre-LN block: x + drop(attn(ln1(x))); x + drop(mlp(ln2(x)))."""

    def __init__(self, width: int, heads: int, mlp_ratio: int = 4,
                 gelu: str = "tanh", dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.gelu = gelu
        self.dropout = dropout
        self.ln1 = LayerNorm(width, LN_EPS, dtype)
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.ln2 = LayerNorm(width, LN_EPS, dtype)
        self.mlp_in = Dense(width, mlp_ratio * width, dtype)
        self.mlp_out = Dense(mlp_ratio * width, width, dtype)

    def draw_masks(self, x: torch.Tensor, gen: Optional[torch.Generator]):
        """The keep masks of the block's two dropout sites (None, None in
        eval mode), in the order the sites apply them."""
        return draw_mask(x, self.dropout, gen), draw_mask(x, self.dropout, gen)

    def body(self, x: torch.Tensor, mask: torch.Tensor, drop_attn=None, drop_mlp=None):
        x = x + apply_mask(self.attn(self.ln1(x), mask), drop_attn, self.dropout)
        h = self.mlp_out(gelu(self.mlp_in(self.ln2(x)), self.gelu))
        return x + apply_mask(h, drop_mlp, self.dropout)

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        return self.body(x, mask, *self.draw_masks(x, gen))


class TextTransformer(nn.Module):
    """BERT-shaped encoder: ids (B, L) -> pooled (B, width), L2-normed."""

    def __init__(
        self,
        width: int = 768,
        depth: int = 4,
        heads: int = 6,
        vocab_size: int = 32768,
        max_len: int = 256,
        gelu: str = "tanh",
        dropout: float = 0.1,
        dtype: Optional[torch.dtype] = None,
        moe_experts: int = 0,
        moe_capacity_factor: float = 1.25,
        remat: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.remat = bool(remat)
        self.moe_experts = int(moe_experts)
        self.tok_embed = nn.Embedding(vocab_size, width)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, width))
        self.ln_embed = LayerNorm(width, LN_EPS, dtype)
        if self.moe_experts > 0:
            # imported here: models/moe.py imports this module's attention
            from ultrafnd_git_tpu_torch.models.moe import MoEEncoderBlock

            blocks = (MoEEncoderBlock(width, heads, num_experts=self.moe_experts,
                                      capacity_factor=moe_capacity_factor, gelu=gelu,
                                      dropout=dropout, dtype=dtype)
                      for _ in range(depth))
        else:
            blocks = (EncoderBlock(width, heads, gelu=gelu, dropout=dropout, dtype=dtype)
                      for _ in range(depth))
        self.blocks = nn.ModuleList(blocks)
        self.ln_final = LayerNorm(width, LN_EPS)  # f32, as the JAX tower's

    def forward(
        self,
        ids: torch.Tensor,
        mask: torch.Tensor,
        gen: Optional[torch.Generator] = None,
        return_aux: bool = False,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """`gen` = None is eval mode; a generator turns dropout on. With
        `return_aux`, (pooled, the mean of the blocks' Switch aux losses;
        0 for dense blocks)."""
        x = self.tok_embed(ids)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.ln_embed(x + self.pos_embed[:, : ids.shape[1]].to(x.dtype))
        aux_total = None  # the Switch aux, summed over MoE blocks
        for block in self.blocks:
            drops = block.draw_masks(x, gen)
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(block.body, x, mask, *drops, use_reentrant=False)
            else:
                out = block.body(x, mask, *drops)
            if self.moe_experts > 0:
                x, aux = out
                aux_total = aux if aux_total is None else aux_total + aux
            else:
                x = out
        x = self.ln_final(x)
        m = mask[..., None]
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        pooled = pooled / (pooled.norm(dim=-1, keepdim=True) + 1e-9)
        if return_aux:
            if aux_total is None:
                return pooled, pooled.new_zeros((), dtype=torch.float32)
            return pooled, aux_total / float(len(self.blocks))
        return pooled
