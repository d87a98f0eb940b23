"""Seeded random weights for the port's modules, from a torch.Generator.

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
        if name == "pos_embed":
            p.normal_(0.0, 0.02, generator=generator)
        elif name == "temperature":
            p.fill_(1.0)
    return module
