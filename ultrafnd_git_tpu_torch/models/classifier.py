"""Calibrated classifier (counterpart of `models/classifier.py:34-136`).

pre-MLP -> NODE forest + linear bypass -> softmax(logits / clip(T, 0.5, 5)).
Training mode (a `torch.Generator` passed as `gen`) drops 0.1 after each
GELU of the pre-MLP (`classifier.py:109,114`) and 0.3 on the per-tree
logits before their mean (`:52-53`).
Parameter names are the reference state-dict keys that
`ultrafnd_git_tpu.utils.torch_transfer.classifier_state_dict_from_params`
writes (`pre.0` / `.3`, `node.trees.{t}.gates.{k}`, `.thresh.{k}`,
`.leaf_logits`, `.tau`, `bypass`, `temperature`).

On a tensor-parallel mesh (`tp`, set by `parallel/mesh.shard_modules_`)
the pre-MLP runs as a Megatron pair (`models/layers.mlp_pair`).

`dtype=torch.bfloat16` is the JAX module's `dtype=jnp.bfloat16`: the two
pre-MLP Dense layers and their GELUs compute in bf16; the forest, the
bypass and the calibrated softmax stay f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ultrafnd_git_tpu_torch.models.dropout import dropout as drop
from ultrafnd_git_tpu_torch.models.layers import Dense, mlp_pair
from ultrafnd_git_tpu_torch.ops.trees import leaf_bit_matrix, oblivious_forest_logits


class ObliviousTree(nn.Module):
    """One tree's parameters, kept per depth as the reference stores them."""

    def __init__(self, in_dim: int, depth: int, num_classes: int, tau: float):
        super().__init__()
        self.gates = nn.ParameterList(
            nn.Parameter(torch.zeros(in_dim)) for _ in range(depth)
        )
        self.thresh = nn.ParameterList(
            nn.Parameter(torch.zeros(1)) for _ in range(depth)
        )
        self.leaf_logits = nn.Parameter(torch.zeros(1 << depth, num_classes))
        self.register_buffer("tau", torch.tensor(float(tau)))


class NODEEnsemble(nn.Module):
    """Forest of soft oblivious trees; mean of per-tree logits."""

    def __init__(self, in_dim: int, num_classes: int = 2, num_trees: int = 6,
                 depth: int = 4, tau: float = 10.0, dropout: float = 0.3):
        super().__init__()
        self.tau = float(tau)
        self.dropout = dropout
        self.trees = nn.ModuleList(
            ObliviousTree(in_dim, depth, num_classes, tau)
            for _ in range(num_trees)
        )
        # not in the state dict: the routing constant moves with the module
        self.register_buffer("leaf_bits", torch.from_numpy(leaf_bit_matrix(depth)),
                             persistent=False)

    def forward(
        self, x: torch.Tensor, gen: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        gates = torch.stack([torch.stack(list(t.gates)) for t in self.trees])
        thresh = torch.stack([torch.cat(list(t.thresh)) for t in self.trees])
        leaf = torch.stack([t.leaf_logits for t in self.trees])
        per_tree = oblivious_forest_logits(x, gates, thresh, leaf, self.tau, self.leaf_bits)
        return drop(per_tree, self.dropout, gen).mean(dim=1)  # (B, C)


class DeepTruthClassifier(nn.Module):
    """Binary truth classifier over fused (+aux) features with calibration."""

    def __init__(
        self,
        in_dim: int = 512,
        hidden: int = 512,
        num_classes: int = 2,
        use_aux: bool = True,
        aux_dim: int = 2,
        node_trees: int = 6,
        node_depth: int = 4,
        node_tau: float = 10.0,
        temperature_init: float = 1.0,
        dropout: float = 0.1,
        node_dropout: float = 0.3,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.use_aux = use_aux
        self.dropout = dropout
        d_in = in_dim + (aux_dim if use_aux else 0)
        self.pre = nn.Sequential(
            Dense(d_in, hidden, dtype),
            nn.GELU(),
            nn.Identity(),  # the reference's dropout slot (see forward)
            Dense(hidden, hidden, dtype),
            nn.GELU(),
        )
        self.node = NODEEnsemble(
            hidden, num_classes, node_trees, node_depth, node_tau, node_dropout
        )
        self.bypass = Dense(hidden, num_classes)
        self.temperature = nn.Parameter(torch.tensor(float(temperature_init)))
        self.tp = None  # the model-axis Shard on a tensor-parallel mesh

    def forward(
        self,
        fused: torch.Tensor,
        aux: Optional[torch.Tensor] = None,
        gen: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """`gen` = None is eval mode; a generator turns dropout on."""
        x = fused
        if self.use_aux and aux is not None:
            x = torch.cat([x, aux], dim=-1)
        h = mlp_pair(self.pre[0], self.pre[3], x, self.dropout, gen, self.tp).float()
        logits = self.node(h, gen) + self.bypass(h)
        t = self.temperature.clamp(0.5, 5.0)
        probs = torch.softmax(logits / t, dim=-1)
        return {"logits": logits, "probs": probs, "temperature": t}
