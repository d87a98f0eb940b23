"""Seeded random weights for the port's modules, from a torch.Generator.

`jax_init_` is the trainer's fresh start: each parameter drawn from the
distribution the JAX package initialises it with (not the same numbers:
the generators differ). `seeded_init_` is for a servable model without a
checkpoint (the GPU smoke run), as follows.

Served models come from JAX checkpoints (`scripts/export_torch_model.py`);
this is for runs that need a model where no JAX is installed (the GPU
smoke run): every parameter is drawn from the given generator. Linear
layers take Flax's `nn.Dense` default, lecun-normal weights and zero
biases: it keeps activations at the scale of the inputs, so a random
model's scores still vary from record to record (with torch's uniform
default the biases swamp the unit-norm features and every record scores
alike). The NODE forest's gates, thresholds and leaf logits are drawn
non-zero (JAX starts them at zero) so that it routes rather than being
bypassed.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ultrafnd_git_tpu_torch.models.classifier import ObliviousTree

_EXPERT_WEIGHTS = ("w_in", "w_out")  # models/moe.MoEFFN's (E, in, out) arrays
_EXPERT_BIASES = ("b_in", "b_out")


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of `module` in place; returns `module`."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                             generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=generator)
        elif isinstance(m, ObliviousTree):
            for g in m.gates:
                g.normal_(0.0, 1.0, generator=generator)
            for t in m.thresh:
                t.uniform_(-0.1, 0.1, generator=generator)
            m.leaf_logits.normal_(0.0, 1.0, generator=generator)
    for name, p in module.named_parameters():
        leaf = name.split(".")[-1]
        if name == "pos_embed":
            p.normal_(0.0, 0.02, generator=generator)
        elif name == "temperature":
            p.fill_(1.0)
        elif leaf in _EXPERT_WEIGHTS:  # a MoE tower's stacked expert matrices
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[-2]), generator=generator)
        elif leaf in _EXPERT_BIASES:
            p.zero_()
    return module


_FROM_ZERO = ("gates", "thresh", "leaf_logits")  # the NODE forest starts at 0


@torch.no_grad()
def jax_init_(part: str, module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill `module` (trainer part "fusion", "clf", "gnn" or "text_tower", or
    the cache's "align" MLP) in place with the JAX package's initial
    distributions; returns `module`.

    fusion, gnn, align: torch.nn.Linear's default, U(+-1/sqrt(fan_in)) weights and
    biases (`models/initializers.torch_dense`); clf: xavier-uniform weights,
    zero biases, a zero forest, temperature 1; text_tower: Flax defaults,
    lecun-normal (truncated) Dense weights with zero biases, embedding
    N(0, 1/width), pos_embed N(0, 0.02), LayerNorm 1 / 0, and a MoE
    block's expert arrays lecun-normal on their 3-D shape (fan_in E * in)
    with zero biases (its router is a Dense).
    """
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan_in, fan_out = m.in_features, m.out_features
            if part in ("fusion", "gnn", "align"):
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif part == "clf":
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()
            else:
                # variance_scaling(1, fan_in, truncated_normal): the std of a
                # N(0, 1) cut at +-2 is 0.87962566
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim), generator=generator)
    for name, p in module.named_parameters():
        leaf = name.split(".")[-2 if name.split(".")[-1].isdigit() else -1]
        if name == "pos_embed":
            p.normal_(0.0, 0.02, generator=generator)
        elif name == "temperature":
            p.fill_(1.0)
        elif leaf in _FROM_ZERO or leaf in _EXPERT_BIASES:
            p.zero_()
        elif leaf in _EXPERT_WEIGHTS:
            # Flax's lecun_normal on the 3-D (E, in, out) shape: fan_in is
            # E * in (its receptive field is the leading axis), not in
            std = 1.0 / math.sqrt(p.shape[:-1].numel()) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
    return module
