"""FLOPs of the LFM2-MoE forward (`lfm2_8b_a1b`), read for hidden states.

A string of L tokens costs, a token: in a conv layer 8 W^2 (in_proj to 3 W,
out_proj); in an attention layer 2 W (2 H D + 2 KV D) in its projections,
and over the string 2 H D L (L + 1) in Q K^T and P V over the causal
triangle; in a dense layer 6 W I; in an expert layer 2 W E in the router
and k 6 W I_e in its k experts (the active ones alone). The embedding
gather, the norms, RoPE, the conv's 3 taps, the softmax and the routing's
sort are left out."""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple


def string_flops(cfg: Dict[str, Any], length: int) -> float:
    w, h, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = w // h
    types = cfg["layer_types"]
    attn = sum(t == "full_attention" for t in types)
    dense = cfg["num_dense_layers"]
    moe = cfg["num_hidden_layers"] - dense
    per_token = ((len(types) - attn) * 8.0 * w * w
                 + attn * 2.0 * w * (2 * h * d + 2 * kv * d)
                 + dense * 6.0 * w * cfg["intermediate_size"]
                 + moe * (2.0 * w * cfg["num_experts"]
                          + cfg["num_experts_per_tok"] * 6.0 * w * cfg["moe_intermediate_size"]))
    return length * per_token + attn * 2.0 * h * d * length * (length + 1)


def real_flops(cfg: Dict[str, Any], lengths: Iterable[int]) -> float:
    """The FLOPs of the real tokens, each string at its own length."""
    return sum(string_flops(cfg, int(n)) for n in lengths)


def attention_shapes(cfg: Dict[str, Any], rows: int, seq: int) -> List[Tuple[int, ...]]:
    """The (B, H, S, D, KV) of each causal attention call of a chunk padded
    to (rows, seq): H query heads over KV heads (the call takes K and V
    repeated to H heads; the function needs them at KV)."""
    h = cfg["num_attention_heads"]
    attn = sum(t == "full_attention" for t in cfg["layer_types"])
    return [(rows, h, seq, cfg["hidden_size"] // h, cfg["num_key_value_heads"])] * attn
