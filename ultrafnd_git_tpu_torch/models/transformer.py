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
blocks. `MultiHeadAttention` and `EncoderBlock.body` take `ring=` (an sp
`Shard`): attention then runs as the ring recurrence over the sequence
slices of the sp group (`kernels/ring_attention.py`, JAX's `"ring:<axis>"`
backend), the mask being the local key slice's; the parameters are the
same on every backend. `parallel/sequence.py` and `parallel/pipeline.py`
apply the tower's own blocks on slices (the trainer's `--sp`, `--pp`).

`dtype=torch.bfloat16` is the JAX tower's `dtype=jnp.bfloat16` (serving's
bf16 lever and the trainer's `bf16_compute`; params stay f32): the
embedding rows, every Dense and the block layer norms' outputs are bf16
(`models/layers.py` mirrors Flax's casts), the padding bias is bf16,
attention runs on K2's bf16 mode and its backward on K3/K4's, and the
final layer norm and the pooling are f32. The bf16 tower is differentiable
(gradients reach the f32 params through the casts); a fully masked record
keeps finite gradients (its rows' P is 1 per key in the backward, and the
pooling gives them no gradient).

`DeviceTextEncoder` is the text ladder's tower rung (JAX
`models/transformer.py:367-535`): a `TextTransformer` on an explicit device
that encodes strings in chunks of power-of-two buckets (padded with "",
whose fully masked rows pool to zeros and are dropped), either the seeded
draw (`models/initializers.jax_init_("text_tower", ...)` from a
torch.Generator: JAX's distribution, not its numbers) or the trained tower
of a `--train_text_tower` checkpoint (`from_checkpoint`), tokenized under
the salt that checkpoint was trained with.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

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
from ultrafnd_git_tpu_torch.models.initializers import jax_init_
from ultrafnd_git_tpu_torch.kernels.ring_attention import ring_attention_local
from ultrafnd_git_tpu_torch.models.layers import Dense, LayerNorm
from ultrafnd_git_tpu_torch.ops.hashing import basis_for_salt, fnv1a_64
from ultrafnd_git_tpu_torch.training.checkpoint import find_slot, read_slot
from ultrafnd_git_tpu_torch.utils.device import resolve_device, to_device

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
    """qkv Dense -> split in three -> (B, H, S, D) -> flash kernel -> out;
    with `ring` (an sp `Shard`) the ring recurrence instead of the kernel,
    over the sequence slices of the group (`x` and `mask` are this rank's)."""

    def __init__(self, width: int, heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if width % heads:
            raise ValueError(f"width={width} not divisible by heads={heads}")
        self.width, self.heads = width, heads
        self.qkv = Dense(width, 3 * width, dtype)
        self.out = Dense(width, width, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, ring=None) -> torch.Tensor:
        b, s, _ = x.shape
        d = self.width // self.heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)  # jnp.split(qkv, 3, -1)

        def heads_first(t):
            return t.reshape(b, s, self.heads, d).transpose(1, 2).contiguous()

        if ring is not None:
            # the local key slice's padding bias, f32, rides the ring
            kbias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]
            o = ring_attention_local(heads_first(q), heads_first(k), heads_first(v), kbias,
                                     ring)
        else:
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

    def body(self, x: torch.Tensor, mask: torch.Tensor, drop_attn=None, drop_mlp=None,
             ring=None):
        x = x + apply_mask(self.attn(self.ln1(x), mask, ring), drop_attn, self.dropout)
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


def _is_model_dir(root: Path) -> bool:
    return (root / "weights.pt").exists() and (root / "meta.json").exists()


def checkpoint_identity(path: str) -> str:
    """`<resolved path>/<slot>` of the tower `DeviceTextEncoder.from_checkpoint(path)`
    serves (the resolved path alone for an exported model directory)."""
    root = Path(path).resolve()
    return str(root) if _is_model_dir(root) else f"{root}/{find_slot(str(root))}"


class DeviceTextEncoder(nn.Module):
    """Corpus-wide text encoding through a `TextTransformer` on `device`
    (cuda by default; raises without a GPU), its attention on K2 there.

    The seeded tower is a fixed random-feature map until trained weights
    are installed (`load_state_dict`, `from_checkpoint`); it warns once when
    it encodes untrained, as the JAX encoder does.
    """

    def __init__(
        self,
        dim: int = 768,
        depth: int = 4,
        heads: int = 6,
        max_len: int = 256,
        vocab_size: int = 32768,
        seed: int = 0,
        moe_experts: int = 0,
        moe_capacity_factor: float = 1.25,
        gelu: str = "tanh",
        device: str = "cuda",
        init_params: bool = True,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.dim, self.max_len, self.vocab_size = int(dim), int(max_len), int(vocab_size)
        self.tower = TextTransformer(width=dim, depth=depth, heads=heads, vocab_size=vocab_size,
                                     max_len=max_len, gelu=gelu, moe_experts=moe_experts,
                                     moe_capacity_factor=moe_capacity_factor)
        if init_params:  # else the caller installs weights (load_state_dict)
            jax_init_("text_tower", self.tower, torch.Generator().manual_seed(int(seed)))
        self.tower.to(self.device).eval()
        self.trained = False
        self._warned = False
        # None tokenizes under the process-wide salt; from_checkpoint pins the
        # salt the tower was trained under without touching the process's
        self.hash_salt: Optional[str] = None

    def load_state_dict(self, state_dict: Mapping[str, Any], strict: bool = True, assign=False):
        """Install tower weights in `TextTransformer`'s layout (numpy arrays,
        as `utils/transfer.tower_state_dict` gives them, or tensors): the
        JAX encoder's `load_params`; the encoder counts as trained after."""
        sd = {k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
              for k, v in state_dict.items()}
        out = self.tower.load_state_dict(sd, strict=strict, assign=assign)
        self.tower.to(self.device)
        self.trained = True
        return out

    @classmethod
    def from_checkpoint(
        cls, path: str, checkpoint_name: Optional[str] = None, device: str = "cuda"
    ) -> "DeviceTextEncoder":
        """The trained tower of a `--train_text_tower` run, as JAX's
        `DeviceTextEncoder.from_checkpoint`: a slot of the port's out_dir
        (`training/checkpoint.read_slot`: `checkpoint_name`, else `best`
        then `latest`; FileNotFoundError without one, ValueError for a JAX
        out_dir) or an exported model directory (weights.pt, meta.json:
        `scripts/export_torch_model.py` carries a JAX out_dir across).
        ValueError when the run did not train a tower. Width and vocabulary
        come from the embedding, max_len from pos_embed, depth, heads, gelu
        and MoE from the recorded tower dims, else from the cfg with JAX's
        defaults (2, 12, "exact": a meta that predates tower_gelu was
        trained exact-erf, 0 experts). The cfg's hash_salt is pinned on
        the encoder."""
        root = Path(path)
        if _is_model_dir(root):
            with open(root / "meta.json", "r", encoding="utf-8") as fh:
                meta = json.load(fh)
            dims = meta.get("text_tower") or {}
            weights = torch.load(root / "weights.pt", map_location="cpu", weights_only=True,
                                 mmap=True)
            sd = weights.get("text_tower")
        else:
            payload, meta = read_slot(str(root), checkpoint_name)
            dims = (meta.get("model") or {}).get("text_tower") or {}
            sd = payload["params"].get("text_tower")
        cfg = meta.get("cfg", {})
        if not cfg.get("train_text_tower") or sd is None:
            raise ValueError(f"checkpoint at {root} was not trained with --train_text_tower; "
                             "nothing to serve")
        embed, pos = sd["tok_embed.weight"], sd["pos_embed"]
        enc = cls(
            dim=int(embed.shape[1]),
            depth=int(dims.get("depth", cfg.get("text_tower_depth", 2))),
            heads=int(dims.get("heads", cfg.get("text_tower_heads", 12))),
            max_len=int(pos.shape[1]),
            vocab_size=int(embed.shape[0]),
            moe_experts=int(dims.get("moe_experts", cfg.get("moe_experts", 0))),
            moe_capacity_factor=float(dims.get("moe_capacity_factor", 1.25)),
            gelu=str(dims.get("gelu", cfg.get("tower_gelu", "exact"))),
            device=device,
            init_params=False,
        )
        enc.load_state_dict(sd)
        enc.hash_salt = str(cfg.get("hash_salt", ""))
        return enc

    def encode_batch(self, texts: Sequence[str], batch_size: int = 512) -> np.ndarray:
        """(N, dim) f32 pooled, L2-normalised encodings. Chunks of
        `batch_size` strings, each padded with "" to a power-of-two bucket of
        at least 8 rows (at most batch_size), tokenized by
        `hash_tokenize_batch` under `hash_salt`; one copy back per chunk."""
        if not self.trained and not self._warned:
            self._warned = True
            print("⚠️  DeviceTextEncoder is serving UNTRAINED (seeded random) features — "
                  "experimental rung; point ULTRAFND_TEXT_DEVICE_CKPT at a "
                  "--train_text_tower run for trained weights")
        out = []
        with torch.inference_mode():
            for s in range(0, len(texts), batch_size):
                chunk = list(texts[s: s + batch_size])
                n = len(chunk)
                bucket = 8
                while bucket < n:
                    bucket *= 2
                chunk += [""] * (min(bucket, batch_size) - n)
                ids, mask = hash_tokenize_batch(chunk, self.max_len, self.vocab_size,
                                                salt=self.hash_salt)
                enc = self.tower(to_device(torch.from_numpy(ids).long(), self.device),
                                 to_device(torch.from_numpy(mask), self.device))
                out.append(enc[:n].cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, self.dim), np.float32)
