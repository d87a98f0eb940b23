"""BERT encoder with HuggingFace weights, its attention on K2 (counterpart of
`ultrafnd_git_tpu/models/bert_flax.py`).

`BertEncoder` is HF's `BertModel` without its pooler: learned word,
position and token-type embeddings, then post-LayerNorm layers (self
attention, exact-erf GELU FFN), `layer_norm_eps` from the config. Its
modules carry HF's names (`embeddings.LayerNorm`,
`encoder.layer.{i}.attention.self.query`, ...), so a `BertModel` or a
task model's `state_dict()` loads as it is (`load_hf_weights` drops the
`bert.` prefix and ignores keys the encoder has no use for, such as the
pooler's). Attention is `kernels.flash_attention.flash_attention` over the
(B, 1, 1, S) padding bias in f32: K2 on a CUDA tensor, which raises on a
head width it was not built for; its plain version on a CPU tensor.
`set_attention(module, plain_attention)` swaps in the plain version on any
device, to hold the kernel against it.

`DeviceBertEncoder` is the text ladder's HF rung on a device
(`bert_flax.py:181-271`): the host tokenizer, then the encoder in chunks
padded to power-of-two (batch, sequence) buckets, the last hidden state
mean-pooled under the mask, fit to `dim` (truncated or zero-padded) and
L2-normalised (+1e-9). `encode_ids` is one `encode.request` span, each
chunk its pad, upload, forward, pool and download spans, then
`encode.finish` (`utils/spans.py`).

The JAX twin runs K2 on the TPU in its default `mm_dtype=bfloat16`; this
one runs it in f32, as the JAX twin's CPU path and the HF forward do
(ROADMAP.md §3).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.kernels.flash_attention import (
    flash_attention,
    padding_bias,
    reference_attention,
)
from ultrafnd_git_tpu_torch.utils.device import resolve_device, to_device
from ultrafnd_git_tpu_torch.utils.spans import span

Attend = Callable[..., torch.Tensor]


def plain_attention(q, k, v, bias=None) -> torch.Tensor:
    """K2's plain version (its output), on any device."""
    return reference_attention(q, k, v, bias)[0]


def set_attention(module: nn.Module, attend: Attend) -> None:
    """Route every attention of `module` through `attend` (q, k, v, bias)."""
    for m in module.modules():
        if isinstance(m, Attention):
            m.attend = attend


def hf_config(config: Any) -> Any:
    """An HF config object as it is; a mapping of HF's config field names as
    an object with those attributes (no `transformers` needed)."""
    return SimpleNamespace(**config) if isinstance(config, Mapping) else config


def model_parts(model: Any, config: Any = None) -> Tuple[Any, Mapping[str, Any]]:
    """(config, state dict) of an HF model, or of a state dict and its config."""
    if hasattr(model, "state_dict"):
        return hf_config(config if config is not None else model.config), model.state_dict()
    if config is None:
        raise ValueError("a state dict needs its config (an HF config or a mapping)")
    return hf_config(config), model


def load_hf_weights(module: nn.Module, state_dict: Mapping[str, Any], prefix: str) -> None:
    """Load `state_dict` (tensors or numpy arrays, keys with or without
    `prefix`) into `module` as f32. Every key of the module must be there;
    keys it does not have are ignored."""
    sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state_dict.items()}
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{type(module).__name__}: weights missing {missing[:5]}"
                       + (f" and {len(missing) - 5} more" if len(missing) > 5 else ""))
    module.load_state_dict({k: _f32(sd[k]) for k in own})


def _f32(v: Any) -> torch.Tensor:
    return (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(torch.float32)


@torch.no_grad()
def draw_weights_(module: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Seeded weights for a twin run without a checkpoint: every parameter
    N(0, std) from a torch.Generator, a norm's scale 1 + N(0, std)."""
    g = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            draw = torch.randn(p.shape, generator=g) * std
            norm_scale = name == "weight" and isinstance(m, (nn.LayerNorm, nn.GroupNorm))
            p.copy_(draw + 1.0 if norm_scale else draw)
    return module


def heads_first(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, W) -> contiguous (B, heads, S, W / heads)."""
    b, s, w = t.shape
    return t.view(b, s, heads, w // heads).transpose(1, 2).contiguous()


def heads_last(t: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H * D)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


class Attention(nn.Module):
    """Base of the twins' self-attentions: `attend` is the attention call."""

    attend: Attend = staticmethod(flash_attention)


class BertSelfAttention(Attention):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        q, k, v = (heads_first(p(x), self.heads) for p in (self.query, self.key, self.value))
        return heads_last(self.attend(q, k, v, bias))


class _DenseNorm(nn.Module):
    """HF's `*Output` blocks: LayerNorm(residual + dense(h))."""

    def __init__(self, d_in: int, width: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, width)
        self.LayerNorm = nn.LayerNorm(width, eps=eps)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dense(h))


class BertAttention(nn.Module):
    def __init__(self, width: int, heads: int, eps: float):
        super().__init__()
        self.self = BertSelfAttention(width, heads)
        self.output = _DenseNorm(width, width, eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class _Intermediate(nn.Module):
    def __init__(self, width: int, intermediate: int):
        super().__init__()
        self.dense = nn.Linear(width, intermediate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # HF "gelu": the exact erf form


class BertLayer(nn.Module):
    """One HF BERT layer: post-LN self-attention, post-LN FFN."""

    def __init__(self, width: int, heads: int, intermediate: int, eps: float = 1e-12):
        super().__init__()
        self.attention = BertAttention(width, heads, eps)
        self.intermediate = _Intermediate(width, intermediate)
        self.output = _DenseNorm(intermediate, width, eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class BertLayers(nn.Module):
    """HF's `encoder`: `layer.{i}`."""

    def __init__(self, depth: int, width: int, heads: int, intermediate: int, eps: float):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(width, heads, intermediate, eps)
                                   for _ in range(depth))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        bias = padding_bias(mask)
        for layer in self.layer:
            x = layer(x, bias)
        return x


class BertEmbeddings(nn.Module):
    def __init__(self, vocab: int, width: int, positions: int, type_vocab: int, eps: float):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, width)
        self.position_embeddings = nn.Embedding(positions, width)
        self.token_type_embeddings = nn.Embedding(type_vocab, width)
        self.LayerNorm = nn.LayerNorm(width, eps=eps)

    def forward(self, ids: torch.Tensor, type_ids: torch.Tensor,
                pos_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pos_ids is None:
            pos_ids = torch.arange(ids.shape[1], device=ids.device)[None]
        return self.LayerNorm(self.word_embeddings(ids) + self.position_embeddings(pos_ids)
                              + self.token_type_embeddings(type_ids))


class BertEncoder(nn.Module):
    """HF `BertModel` without the pooler: ids, mask -> last hidden state."""

    def __init__(self, width: int = 768, depth: int = 12, heads: int = 12,
                 intermediate: int = 3072, vocab_size: int = 30522, max_positions: int = 512,
                 type_vocab: int = 2, ln_eps: float = 1e-12):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, width, max_positions, type_vocab, ln_eps)
        self.encoder = BertLayers(depth, width, heads, intermediate, ln_eps)

    @classmethod
    def from_config(cls, config: Any) -> "BertEncoder":
        cfg = hf_config(config)
        return cls(width=cfg.hidden_size, depth=cfg.num_hidden_layers,
                   heads=cfg.num_attention_heads, intermediate=cfg.intermediate_size,
                   vocab_size=cfg.vocab_size, max_positions=cfg.max_position_embeddings,
                   type_vocab=cfg.type_vocab_size,
                   ln_eps=float(getattr(cfg, "layer_norm_eps", 1e-12)))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids (B, S) int, mask (B, S) 1/0 -> (B, S, width) f32."""
        if type_ids is None:
            type_ids = torch.zeros_like(ids)
        return self.encoder(self.embeddings(ids, type_ids), mask)


def seq_bucket(n: int, cap: int, smallest: int = 32) -> int:
    """The power-of-two bucket (from `smallest`) that holds n, at most cap."""
    b = smallest
    while b < n:
        b *= 2
    return min(b, cap)


def pad_to(a: np.ndarray, rows: int, cols: int, value=0) -> np.ndarray:
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])), constant_values=value)


def fit_dim(vecs: np.ndarray, dim: int) -> np.ndarray:
    """Truncate to, or zero-pad up to, `dim` columns."""
    if vecs.shape[-1] > dim:
        return vecs[..., :dim]
    if vecs.shape[-1] < dim:
        return np.pad(vecs, ((0, 0), (0, dim - vecs.shape[-1])))
    return vecs


def l2_rows(vecs: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    return (vecs / (np.linalg.norm(vecs, axis=-1, keepdims=True) + eps)).astype(np.float32)


def tokenize(tokenizer, texts: List[str], max_length: int,
             padding: Any = True) -> Tuple[np.ndarray, np.ndarray]:
    """(ids int64, mask f32) of an HF tokenizer call on `texts`."""
    enc = tokenizer(texts, padding=padding, truncation=True, max_length=max_length,
                    return_tensors="np")
    return (np.asarray(enc["input_ids"], np.int64),
            np.asarray(enc["attention_mask"], np.float32))


class DeviceBertEncoder:
    """HF BERT weights in a `BertEncoder` on `device` (cuda by default;
    raises without a GPU): strings -> (N, dim) L2-normalised rows.

    `model` is an HF BERT model, or a state dict (`BertModel` keys, with or
    without `bert.`) with its `config` (an HF config or a mapping of its
    fields). `tokenizer` is an HF tokenizer (or any callable with its call
    contract and `return_tensors="np"`).
    """

    def __init__(self, model: Any, tokenizer: Any, dim: int = 768, max_length: int = 256,
                 batch_size: int = 256, device: str = "cuda", config: Any = None):
        cfg, sd = model_parts(model, config)
        self.device = resolve_device(device)
        self.dim, self.max_length, self.batch_size = int(dim), int(max_length), int(batch_size)
        self.tok = tokenizer
        self.module = BertEncoder.from_config(cfg)
        load_hf_weights(self.module, sd, "bert.")
        self.module.to(self.device).eval()

    @torch.inference_mode()
    def _pooled(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One chunk, padded to its (batch, sequence) bucket: (n, width)
        rows of the mean of the last hidden state under the mask."""
        n = ids.shape[0]
        with span("encode.pad"):
            sb = seq_bucket(ids.shape[1], self.max_length)
            bb = seq_bucket(n, self.batch_size)
            ids_p, mask_p = pad_to(ids, bb, sb), pad_to(mask, bb, sb)
        with span("encode.upload"):
            ids_t = to_device(torch.from_numpy(ids_p), self.device)
            mask_t = to_device(torch.from_numpy(mask_p), self.device)
        with span("encode.forward"):
            hidden = self.module(ids_t, mask_t)
        with span("encode.pool"):
            m = mask_t[..., None]
            rep = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)
        with span("encode.download"):
            return rep[:n].cpu().numpy()

    def _finish(self, outs: List[np.ndarray]) -> np.ndarray:
        with span("encode.finish"):
            if not outs:
                return np.zeros((0, self.dim), np.float32)
            return l2_rows(fit_dim(np.concatenate(outs, axis=0), self.dim))

    def encode_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Token ids (N, L) and their 1/0 mask -> (N, dim), in chunks of
        `batch_size` (L at most `max_length`)."""
        with span("encode.request"):
            return self._finish([
                self._pooled(ids[s:s + self.batch_size], mask[s:s + self.batch_size])
                for s in range(0, len(ids), self.batch_size)])

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Strings -> (N, dim): tokenized a chunk at a time."""
        return self._finish([
            self._pooled(*tokenize(self.tok, list(texts[s:s + self.batch_size]), self.max_length))
            for s in range(0, len(texts), self.batch_size)])
