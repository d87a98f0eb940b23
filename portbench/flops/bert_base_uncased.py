"""FLOPs of the BERT encoder's forward (`bert_base_uncased`).

A string of L tokens costs, in each layer, 2 L W (3 W + W + 2 I) in its
projections and feed-forward and 4 L^2 W in Q K^T and P V over all heads.
The pooling, norms, softmax and embedding gathers are left out."""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple


def string_flops(cfg: Dict[str, Any], length: int) -> float:
    w, i, depth = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    return depth * (2.0 * length * w * (4 * w + 2 * i) + 4.0 * length * length * w)


def real_flops(cfg: Dict[str, Any], lengths: Iterable[int]) -> float:
    """The FLOPs of the real tokens, each string at its own length."""
    return sum(string_flops(cfg, int(n)) for n in lengths)


def attention_shapes(cfg: Dict[str, Any], rows: int, seq: int) -> List[Tuple[int, int, int, int]]:
    """The (B, H, S, D) of each attention call of a chunk padded to (rows, seq)."""
    h = cfg["num_attention_heads"]
    return [(rows, h, seq, cfg["hidden_size"] // h)] * cfg["num_hidden_layers"]
