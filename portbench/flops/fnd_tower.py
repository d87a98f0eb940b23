"""FLOPs of one training step of the v2 tower model (`fnd_tower`).

Forward at the step's shapes (the batch's padded rows count: the step
computes them), times 3 for forward and backward (backward at 2x forward).
Element-wise work, norms, softmax and the embedding gather are left out."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple


def forward_flops(cfg: Dict[str, Any], batch: int) -> float:
    t, f, c, g, corpus = cfg["tower"], cfg["fusion"], cfg["classifier"], cfg["gnn"], cfg["corpus"]
    w, s, depth = t["width"], t["max_len"], t["depth"]
    tokens = batch * s
    # a block: qkv (3 W^2), out (W^2), mlp_in and mlp_out (4 W^2 each); Q K^T and P V
    tower = depth * (2.0 * tokens * w * w * 12 + 4.0 * batch * s * s * w)
    n, gin = corpus["n"], sum(width for _, width in g["slices"])
    hid, out = 2 * g["dim"], g["dim"]
    gcn = 2.0 * n * gin * hid + 2.0 * batch * n * hid + 2.0 * batch * hid * out
    h = f["hidden"]
    widths = (corpus["text"], corpus["audio"], corpus["visual"], corpus["temporal"])
    fusion = 2.0 * batch * h * sum(widths)
    fusion += 3 * (3 * 2.0 * batch * h * h + 2.0 * batch * 3 * h + 2.0 * batch * h)  # co-attention
    fusion += 2.0 * batch * g["dim"] * h  # gnn_proj
    parts = 15 + (1 if f["use_gnn"] else 0)
    fusion += 2.0 * batch * parts * h * 2 * h + 2.0 * batch * 2 * h * h  # fuse MLP
    fusion += 2.0 * batch * h * 2  # the fusion's logits head
    ch, trees, tdepth = c["hidden"], c["node_trees"], c["node_depth"]
    d_in = h + (c["aux_dim"] if c["use_aux"] else 0)
    clf = 2.0 * batch * d_in * ch + 2.0 * batch * ch * ch
    clf += 2.0 * batch * trees * tdepth * ch  # the forest's feature choice
    clf += 2.0 * batch * trees * (1 << tdepth) * c["num_classes"]  # leaf mixture
    clf += 2.0 * batch * ch * c["num_classes"]  # bypass
    return tower + gcn + fusion + clf


def step_flops(cfg: Dict[str, Any], batch: int) -> float:
    return 3.0 * forward_flops(cfg, batch)


def attention_shapes(cfg: Dict[str, Any], batch: int) -> List[Tuple[int, int, int, int]]:
    """The (B, H, S, D) of each attention call of a step, forward and backward alike."""
    t = cfg["tower"]
    return [(batch, t["heads"], t["max_len"], t["width"] // t["heads"])] * t["depth"]
