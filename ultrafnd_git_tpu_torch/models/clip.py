"""CLIP text tower with HuggingFace weights (counterpart of
`ultrafnd_git_tpu/models/clip_flax.py`).

`ClipTextEncoder` is HF's `CLIPTextModelWithProjection` (the text half of
`openai/clip-vit-base-patch32`): token and position embeddings,
pre-LayerNorm layers with causal self-attention and quick-GELU (or the
config's `hidden_act`), a final LayerNorm, pooling at the EOS token and a
projection without bias. The pooled position is the first where the ids
equal `eos_token_id`; a config whose `eos_token_id` is 2 (the OpenAI
releases) pools at argmax(ids) instead, HF's legacy rule, kept for parity.
Module names are HF's with the `text_model.` prefix dropped (a `CLIPModel`,
`CLIPTextModel` or `CLIPTextModelWithProjection` state dict loads as it
is; the vision tower's keys are ignored).

Attention is the plain f32 softmax over a (B, 1, S, S) causal + padding
bias (`kernels.flash_attention.reference_attention`), as the JAX twin's is
(`reference_attention`, outside any `pallas_call`): K2 takes a (B, 1, 1, S)
key-padding bias only. `DeviceClipTextEncoder` is the semantic analyzer's
rung on a device: strings padded to `max_length`, chunks padded to a
power-of-two batch, the projected features L2-normalised (+1e-9).
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.kernels.flash_attention import NEG_INF, reference_attention
from ultrafnd_git_tpu_torch.models.bert import (
    heads_first,
    heads_last,
    hf_config,
    l2_rows,
    load_hf_weights,
    model_parts,
    pad_to,
    seq_bucket,
    tokenize,
)
from ultrafnd_git_tpu_torch.utils.device import resolve_device, to_device


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "quick_gelu": quick_gelu,
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}


class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        q, k, v = (heads_first(p(x), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(heads_last(reference_attention(q, k, v, bias)[0]))


class ClipMLP(nn.Module):
    def __init__(self, width: int, intermediate: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(width, intermediate)
        self.fc2 = nn.Linear(intermediate, width)
        self.act = ACTIVATIONS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class ClipLayer(nn.Module):
    """Pre-LN causal attention, then pre-LN MLP."""

    def __init__(self, width: int, heads: int, intermediate: int, act: str, eps: float):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=eps)
        self.self_attn = ClipAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=eps)
        self.mlp = ClipMLP(width, intermediate, act)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class ClipEmbeddings(nn.Module):
    def __init__(self, vocab: int, width: int, positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.position_embedding = nn.Embedding(positions, width)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        return self.token_embedding(ids) + self.position_embedding(pos)


class ClipLayers(nn.Module):
    """HF's `encoder`: `layers.{i}`."""

    def __init__(self, depth: int, width: int, heads: int, intermediate: int, act: str,
                 eps: float):
        super().__init__()
        self.layers = nn.ModuleList(ClipLayer(width, heads, intermediate, act, eps)
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, bias)
        return x


class ClipTextEncoder(nn.Module):
    """HF `CLIPTextModelWithProjection`: ids, mask -> (text features (B,
    proj_dim), not normalised, as `get_text_features`; last hidden state)."""

    def __init__(self, width: int = 512, depth: int = 12, heads: int = 8,
                 intermediate: int = 2048, vocab_size: int = 49408, max_positions: int = 77,
                 proj_dim: int = 512, hidden_act: str = "quick_gelu", ln_eps: float = 1e-5,
                 eos_token_id: int = 49407):
        super().__init__()
        self.eos_token_id = int(eos_token_id)
        self.legacy_eos_pooling = self.eos_token_id == 2
        self.embeddings = ClipEmbeddings(vocab_size, width, max_positions)
        self.encoder = ClipLayers(depth, width, heads, intermediate, hidden_act, ln_eps)
        self.final_layer_norm = nn.LayerNorm(width, eps=ln_eps)
        self.text_projection = nn.Linear(width, proj_dim, bias=False)

    @classmethod
    def from_config(cls, config: Any) -> "ClipTextEncoder":
        """A `CLIPConfig` (its `text_config` and `projection_dim`) or a
        `CLIPTextConfig`, or a mapping of either's fields."""
        cfg = hf_config(config)
        text = hf_config(getattr(cfg, "text_config", cfg))
        return cls(width=text.hidden_size, depth=text.num_hidden_layers,
                   heads=text.num_attention_heads, intermediate=text.intermediate_size,
                   vocab_size=text.vocab_size, max_positions=text.max_position_embeddings,
                   proj_dim=int(getattr(cfg, "projection_dim", 512)),
                   hidden_act=str(getattr(text, "hidden_act", "quick_gelu")),
                   ln_eps=float(getattr(text, "layer_norm_eps", 1e-5)),
                   eos_token_id=int(getattr(text, "eos_token_id", 49407)))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        s = ids.shape[1]
        x = self.embeddings(ids)
        causal = torch.triu(torch.full((s, s), NEG_INF, dtype=x.dtype, device=x.device),
                            diagonal=1)
        pad = (1.0 - mask.to(x.dtype)) * NEG_INF  # (B, S)
        x = self.final_layer_norm(self.encoder(x, causal[None, None] + pad[:, None, None, :]))
        if self.legacy_eos_pooling:
            eos = ids.argmax(dim=-1)
        else:
            eos = (ids == self.eos_token_id).int().argmax(dim=-1)  # the first EOS
        pooled = x[torch.arange(ids.shape[0], device=ids.device), eos]
        return self.text_projection(pooled), x


class DeviceClipTextEncoder:
    """HF CLIP text-tower weights in a `ClipTextEncoder` on `device` (cuda
    by default; raises without a GPU): strings -> (N, proj_dim)
    L2-normalised features.

    `model` is an HF `CLIPModel` or `CLIPTextModelWithProjection`, or a
    state dict with its `config` (an HF config or a mapping of its fields).
    """

    def __init__(self, model: Any, tokenizer: Any, max_length: int = 64,
                 batch_size: int = 256, device: str = "cuda", config: Any = None):
        cfg, sd = model_parts(model, config)
        self.device = resolve_device(device)
        self.tok = tokenizer
        self.max_length, self.batch_size = int(max_length), int(batch_size)
        self.module = ClipTextEncoder.from_config(cfg)
        load_hf_weights(self.module, sd, "text_model.")
        self.module.to(self.device).eval()
        self.proj_dim = self.module.text_projection.out_features

    @torch.inference_mode()
    def _features(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One chunk, padded to its power-of-two batch: (n, proj_dim)."""
        n = ids.shape[0]
        bb = seq_bucket(n, self.batch_size)
        ids_t = to_device(torch.from_numpy(pad_to(ids, bb, ids.shape[1])), self.device)
        mask_t = to_device(torch.from_numpy(pad_to(mask, bb, ids.shape[1])), self.device)
        return self.module(ids_t, mask_t)[0][:n].cpu().numpy()

    def _finish(self, outs: List[np.ndarray]) -> np.ndarray:
        if not outs:
            return np.zeros((0, self.proj_dim), np.float32)
        return l2_rows(np.concatenate(outs, axis=0))

    def encode_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Token ids (N, L) and their 1/0 mask -> (N, proj_dim)."""
        return self._finish([self._features(ids[s:s + self.batch_size],
                                            mask[s:s + self.batch_size])
                             for s in range(0, len(ids), self.batch_size)])

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Strings, padded to `max_length` tokens -> (N, proj_dim)."""
        return self._finish([
            self._features(*tokenize(self.tok, [t or "" for t in texts[s:s + self.batch_size]],
                                     self.max_length, padding="max_length"))
            for s in range(0, len(texts), self.batch_size)])
