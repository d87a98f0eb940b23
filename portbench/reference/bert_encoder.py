"""BERT encoder (bert-base-uncased's `BertModel` without its pooler) and the
text ladder's pooling, in plain PyTorch.

Learned word, position and token-type (all type 0) embeddings summed and
layer-normed; each layer post-LN: x = LN(x + Wo attn(x)), x = LN(x +
W2 gelu_erf(W1 x)); attention softmax(q k^T / sqrt(D)) v with the padded
keys masked out. Then the mean of the last hidden state over the real
tokens, cut or zero-padded to `dim`, and L2-normalised (+1e-9). Weights use
HuggingFace's key names."""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

Spec = List[Tuple[str, Tuple[int, ...], float, float]]  # (name, shape, mean, std)


def param_spec(cfg: Dict[str, Any]) -> Dict[str, Spec]:
    """{part: [(HF key, shape, mean, std)]}: HF's initializer, N(0, 0.02),
    and 1 + N(0, 0.02) for the norm scales."""
    w, i, std = cfg["hidden_size"], cfg["intermediate_size"], cfg["initializer_range"]
    spec: Spec = [
        ("embeddings.word_embeddings.weight", (cfg["vocab_size"], w), 0.0, std),
        ("embeddings.position_embeddings.weight", (cfg["max_position_embeddings"], w), 0.0, std),
        ("embeddings.token_type_embeddings.weight", (cfg["type_vocab_size"], w), 0.0, std),
        ("embeddings.LayerNorm.weight", (w,), 1.0, std),
        ("embeddings.LayerNorm.bias", (w,), 0.0, std),
    ]
    for layer in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{layer}."
        for name, shape in (
            ("attention.self.query", (w, w)), ("attention.self.key", (w, w)),
            ("attention.self.value", (w, w)), ("attention.output.dense", (w, w)),
            ("intermediate.dense", (i, w)), ("output.dense", (w, i)),
        ):
            spec += [(p + name + ".weight", shape, 0.0, std),
                     (p + name + ".bias", (shape[0],), 0.0, std)]
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            spec += [(p + ln + ".weight", (w,), 1.0, std), (p + ln + ".bias", (w,), 0.0, std)]
    return {"bert": spec}


@contextmanager
def matmul_precision(tf32: bool):
    """TF32 off (the reference) or on (the control) for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _linear(wts, name, x):
    return x @ wts[name + ".weight"].t() + wts[name + ".bias"]


def _norm(wts, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), wts[name + ".weight"], wts[name + ".bias"], eps)


@torch.no_grad()
def encode(cfg: Dict[str, Any], wts: Dict[str, torch.Tensor], ids: torch.Tensor,
           mask: torch.Tensor, dim: int, tf32: bool = False) -> torch.Tensor:
    """ids (N, L) int, mask (N, L) 1/0 -> (N, dim) f32 rows."""
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    n, length = ids.shape
    w = cfg["hidden_size"]
    d = w // heads
    with matmul_precision(tf32):
        pos = torch.arange(length, device=ids.device)
        x = (wts["embeddings.word_embeddings.weight"][ids]
             + wts["embeddings.position_embeddings.weight"][pos][None]
             + wts["embeddings.token_type_embeddings.weight"][0])
        x = _norm(wts, "embeddings.LayerNorm", x, eps)
        keep = mask.bool()[:, None, None, :]
        for layer in range(cfg["num_hidden_layers"]):
            p = f"encoder.layer.{layer}."

            def split(t):
                return t.view(n, length, heads, d).transpose(1, 2)

            q = split(_linear(wts, p + "attention.self.query", x))
            k = split(_linear(wts, p + "attention.self.key", x))
            v = split(_linear(wts, p + "attention.self.value", x))
            s = (q @ k.transpose(-1, -2)) / math.sqrt(d)
            s = s.masked_fill(~keep, float("-inf"))
            a = torch.softmax(s, dim=-1) @ v
            a = a.transpose(1, 2).reshape(n, length, w)
            x = _norm(wts, p + "attention.output.LayerNorm",
                      x + _linear(wts, p + "attention.output.dense", a), eps)
            h = F.gelu(_linear(wts, p + "intermediate.dense", x))
            x = _norm(wts, p + "output.LayerNorm", x + _linear(wts, p + "output.dense", h), eps)
        m = mask.to(x.dtype)[..., None]
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)
        if pooled.shape[1] > dim:
            pooled = pooled[:, :dim]
        elif pooled.shape[1] < dim:
            pooled = F.pad(pooled, (0, dim - pooled.shape[1]))
        return pooled / (pooled.norm(dim=-1, keepdim=True) + 1e-9)
