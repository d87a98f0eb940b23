"""Text tower over the flash-attention kernel (dense MLP blocks).

Counterpart of `ultrafnd_git_tpu/models/transformer.py`: the hash
tokenizer, `MultiHeadAttention`, `EncoderBlock` and `TextTransformer`
(ids (B, L) -> mean-pooled, L2-normalised (B, width)). Parameter names
follow the Flax tree (`utils/transfer.py` maps one onto the other). Every
attention call goes through `kernels.flash_attention_fwd`, whatever S is: on
a CUDA tensor that is the hand-written kernel. MoE blocks, remat, ring
attention and coord dropout are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu.ops.hashing import basis_for_salt, fnv1a_64
from ultrafnd_git_tpu_torch.kernels.flash_attention import (
    flash_attention_fwd,
    padding_bias,
)

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

    def __init__(self, width: int, heads: int):
        super().__init__()
        if width % heads:
            raise ValueError(f"width={width} not divisible by heads={heads}")
        self.width, self.heads = width, heads
        self.qkv = nn.Linear(width, 3 * width)
        self.out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        d = self.width // self.heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)  # jnp.split(qkv, 3, -1)

        def heads_first(t):
            return t.reshape(b, s, self.heads, d).transpose(1, 2).contiguous()

        o, _ = flash_attention_fwd(
            heads_first(q), heads_first(k), heads_first(v), padding_bias(mask)
        )  # (B, H, S, D)
        return self.out(o.transpose(1, 2).reshape(b, s, self.width))


class EncoderBlock(nn.Module):
    """Pre-LN block: x + attn(ln1(x)); x + mlp(ln2(x)). Eval only."""

    def __init__(self, width: int, heads: int, mlp_ratio: int = 4,
                 gelu: str = "tanh"):
        super().__init__()
        self.gelu = gelu
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = MultiHeadAttention(width, heads)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp_in = nn.Linear(width, mlp_ratio * width)
        self.mlp_out = nn.Linear(mlp_ratio * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.mlp_out(gelu(self.mlp_in(self.ln2(x)), self.gelu))


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
    ):
        super().__init__()
        self.tok_embed = nn.Embedding(vocab_size, width)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, width))
        self.ln_embed = nn.LayerNorm(width, eps=LN_EPS)
        self.blocks = nn.ModuleList(
            EncoderBlock(width, heads, gelu=gelu) for _ in range(depth)
        )
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.tok_embed(ids) + self.pos_embed[:, : ids.shape[1]]
        x = self.ln_embed(x)
        for block in self.blocks:
            x = block(x, mask)
        x = self.ln_final(x)
        m = mask[..., None]
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        return pooled / (pooled.norm(dim=-1, keepdim=True) + 1e-9)
