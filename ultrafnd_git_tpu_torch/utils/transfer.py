"""Weight bridge: the JAX package's parameter tree -> the port's state dicts.

Input is the JAX `TrainState.params` tree as nested dicts of numpy arrays
(`fusion`, `clf`, `gnn`, `text_tower`) plus the temporal align MLP's
variables. Dense kernels (in, out) become `Linear.weight` (out, in).
Fusion, classifier and GCN go through the existing reference-layout
functions of `ultrafnd_git_tpu.utils.torch_transfer`, whose keys the
port's modules are named after. The module imports no jax: the caller
converts arrays to numpy.

A model directory holds `weights.pt` ({part: state_dict}, loadable with
`torch.load(..., weights_only=True)`), `meta.json` (the checkpoint cfg
plus resolved module dims) and the corpus `feature_cache.npz`.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ultrafnd_git_tpu.utils.torch_transfer import (
    classifier_state_dict_from_params,
    fusion_state_dict_from_params,
    gcn_state_dict_from_params,
)

StateDict = Dict[str, np.ndarray]


def _f32(x: Any) -> np.ndarray:
    return np.array(x, dtype=np.float32, order="C")  # a writable copy


def _dense(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _f32(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _f32(p["bias"])


def _layer_norm(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _f32(p["scale"])
    out[f"{name}.bias"] = _f32(p["bias"])


def tower_state_dict(params: Mapping[str, Any]) -> StateDict:
    """Flax `TextTransformer` params -> port `TextTransformer` state dict."""
    out: StateDict = {
        "tok_embed.weight": _f32(params["tok_embed"]["embedding"]),
        "pos_embed": _f32(params["pos_embed"]),
    }
    _layer_norm(out, "ln_embed", params["ln_embed"])
    depth = sum(1 for k in params if k.startswith("block"))
    for i in range(depth):
        p, pre = params[f"block{i}"], f"blocks.{i}"
        _layer_norm(out, f"{pre}.ln1", p["ln1"])
        _dense(out, f"{pre}.attn.qkv", p["attn"]["qkv"])
        _dense(out, f"{pre}.attn.out", p["attn"]["out"])
        _layer_norm(out, f"{pre}.ln2", p["ln2"])
        _dense(out, f"{pre}.mlp_in", p["mlp_in"])
        _dense(out, f"{pre}.mlp_out", p["mlp_out"])
    _layer_norm(out, "ln_final", params["ln_final"])
    return out


def align_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax `TemporalAlignMLP` variables (or their "params") -> state dict."""
    params = variables.get("params", variables)
    out: StateDict = {}
    _dense(out, "proj_in", params["proj_in"])
    _dense(out, "proj_out", params["proj_out"])
    return out


def fusion_state_dict(params: Mapping[str, Any]) -> StateDict:
    # the reference layout adds zero-filled semantic.* entries that only its
    # own strict loader needs; no fusion forward reads them
    sd = fusion_state_dict_from_params(params)
    return {k: v for k, v in sd.items() if not k.startswith("semantic.")}


def port_state_dicts(
    params: Mapping[str, Any],
    align_variables: Mapping[str, Any],
    node_tau: float,
) -> Dict[str, StateDict]:
    """The whole JAX tree -> {"fusion", "clf", "align", ["gnn"], ["text_tower"]}."""
    out = {
        "fusion": fusion_state_dict(params["fusion"]),
        "clf": classifier_state_dict_from_params(params["clf"], tau=node_tau),
        "align": align_state_dict(align_variables),
    }
    if "gnn" in params:
        out["gnn"] = gcn_state_dict_from_params(params["gnn"])
    if "text_tower" in params:
        out["text_tower"] = tower_state_dict(params["text_tower"])
    return out


def write_model_dir(
    model_dir: str,
    state_dicts: Mapping[str, Mapping[str, Any]],
    meta: Mapping[str, Any],
    cache_npz: Optional[str] = None,
) -> Path:
    """Write weights.pt and meta.json (and copy the cache npz) into model_dir."""
    root = Path(model_dir)
    root.mkdir(parents=True, exist_ok=True)
    def tensor(v):
        return v.detach().cpu() if torch.is_tensor(v) else torch.tensor(np.asarray(v))

    torch.save(
        {
            part: {k: tensor(v) for k, v in sd.items()}
            for part, sd in state_dicts.items()
        },
        root / "weights.pt",
    )
    with open(root / "meta.json", "w", encoding="utf-8") as fh:
        json.dump(meta, fh, indent=2, sort_keys=True)
    if cache_npz is not None:
        shutil.copyfile(cache_npz, root / "feature_cache.npz")
    return root
