"""The plain LFM2-MoE reference the port's tests hold the LM rung to, and a
small configuration of it (a helper module, not a test file).

The reference itself is the benchmark's (`portbench/reference/lfm2_encoder.py`):
plain PyTorch in float32 with TF32 off, no kernel of the port, no cache, no
batching of strings, one loop over the experts; it follows the published
description and notes its departures there. `draw` gives seeded weights in
the published checkpoint's key names."""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from portbench.reference import lfm2_encoder
from portbench.reference.lfm2_encoder import param_spec

# width 128, 4 layers (conv, conv, attention, conv), one dense layer, 8
# experts top-2, two query heads of 64 over one KV head
SMALL = {
    "hidden_size": 128, "intermediate_size": 256, "moe_intermediate_size": 64,
    "num_hidden_layers": 4, "layer_types": ["conv", "conv", "full_attention", "conv"],
    "num_attention_heads": 2, "num_key_value_heads": 1, "conv_L_cache": 3, "conv_bias": False,
    "norm_eps": 1e-5, "num_dense_layers": 1, "num_experts": 8, "num_experts_per_tok": 2,
    "norm_topk_prob": True, "routed_scaling_factor": 1.0, "use_expert_bias": True,
    "rope_theta": 1e6, "vocab_size": 300, "max_position_embeddings": 512,
    "weights": {"std": 0.05, "conv_std": 0.57735, "expert_bias_std": 0.1},
}


def hidden(cfg, wts, ids, mask) -> torch.Tensor:
    """The reference's last hidden state, routing by its own choice."""
    return lfm2_encoder.hidden(cfg, wts, ids, mask)[0]


def encode(cfg, wts, ids, mask, dim) -> torch.Tensor:
    """The reference's rows, routing by its own choice."""
    return lfm2_encoder.encode(cfg, wts, ids, mask, dim)[0]


def draw(cfg: Dict[str, Any] = SMALL, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded f32 weights of `param_spec(cfg)` on the CPU."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, mean, std in param_spec(cfg)["lm"]:
        out[name] = torch.randn(math.prod(shape), generator=g).view(shape) * std + mean
    return out
