"""Weights drawn by the benchmark from the seed, on the device, in one call.

A spec is {part: [(name, shape, mean, std)]} (`reference/*.param_spec`).
One normal draw from a `torch.Generator` seeded with the seed fills every
leaf, each scaled by its std and shifted by its mean, in f32: the same seed
gives the same weights, and both sides of the comparison get them."""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.bert_encoder import Spec


def draw(spec: Dict[str, Spec], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    total = sum(math.prod(shape) for leaves in spec.values() for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for part, leaves in spec.items():
        out[part] = {}
        for name, shape, mean, std in leaves:
            n = math.prod(shape)
            out[part][name] = flat[at:at + n].view(shape).mul_(std).add_(mean)
            at += n
    return out
