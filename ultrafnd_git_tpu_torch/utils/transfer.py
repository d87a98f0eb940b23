"""Weight bridge: the JAX package's parameter tree -> the port's state dicts.

Input is the JAX `TrainState.params` tree as nested dicts of numpy arrays
(`fusion`, `clf`, `gnn`, `text_tower`), or a gradient tree of the same
structure, plus the temporal align MLP's variables (and, on its own, the
`SemanticProjector`'s, which no v2 path applies). Dense kernels (in,
out) become `Linear.weight` (out, in). Fusion, classifier and GCN map to
the reference PyTorch layout (`fusion_/classifier_/gcn_state_dict_from_params`,
the port's copies of the functions of the JAX package's
`utils/torch_transfer.py`), whose keys the port's modules are named after.
The v1 ensemble's stacked tree (a leading member axis on every leaf) maps
member by member (`ensemble_state_dicts_from_params`). The caller
converts arrays to numpy.

A model directory holds `weights.pt` ({part: state_dict}, loadable with
`torch.load(..., weights_only=True)`), `meta.json` (the checkpoint cfg
plus resolved module dims; a tower's record `moe_experts` and
`moe_capacity_factor`, 0 and 1.25 for dense blocks) and the corpus
`feature_cache.npz`.
`export_trained` writes one from a checkpoint of the port's own trainer;
`trained_model` gives the same weights and meta in memory (the Predictor's
`out_dir=`).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ultrafnd_git_tpu_torch.data.cache import load_align

StateDict = Dict[str, np.ndarray]


def _f32(x: Any) -> np.ndarray:
    return np.array(x, dtype=np.float32, order="C")  # a writable copy


def _dense(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _f32(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _f32(p["bias"])


def _layer_norm(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _f32(p["scale"])
    out[f"{name}.bias"] = _f32(p["bias"])


def _coattn(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    for key, sub in (("q", "q"), ("k", "k"), ("v", "v"),
                     ("evidence_proj.0", "evidence_in"), ("evidence_proj.2", "evidence_out")):
        _dense(out, f"{name}.{key}", p[sub])


def fusion_state_dict_from_params(params: Mapping[str, Any]) -> StateDict:
    """Fusion params -> the reference `CrossModalTransformer` state dict,
    with the zero-filled `semantic.{text,vision}_proj.0` entries (512 x 512,
    CLIP-width constants) that only the reference's strict loader needs."""
    out: StateDict = {}
    for name in ("text_proj", "audio_proj", "visual_proj", "temporal_proj"):
        _dense(out, name, params[name])
    if "gnn_proj" in params:
        _dense(out, "gnn_proj", params["gnn_proj"])
    for name in ("semantic.text_proj.0", "semantic.vision_proj.0"):
        out[f"{name}.weight"] = np.zeros((512, 512), dtype=np.float32)
        out[f"{name}.bias"] = np.zeros((512,), dtype=np.float32)
    for name in ("attn_tv", "attn_ta", "attn_vu"):
        _coattn(out, name, params[name])
    _dense(out, "fuse_mlp.0", params["fuse0"])
    _dense(out, "fuse_mlp.3", params["fuse1"])
    _dense(out, "classifier", params["head"])
    return out


def classifier_state_dict_from_params(params: Mapping[str, Any], tau: float = 10.0) -> StateDict:
    """Classifier params -> the reference `DeepTruthClassifier` state dict:
    the stacked forest (gates (T, K, F), thresholds (T, K), leaf logits
    (T, 2^K, C)) split per tree and depth, `tau` per tree."""
    out: StateDict = {"temperature": _f32(params["temperature"]).reshape(())}
    _dense(out, "pre.0", params["pre0"])
    _dense(out, "pre.3", params["pre1"])
    node = params["node"]
    gates, thresh, leaf = (_f32(node[k]) for k in ("gates", "thresh", "leaf_logits"))
    trees, depth, _ = gates.shape
    for t in range(trees):
        out[f"node.trees.{t}.tau"] = np.asarray(tau, dtype=np.float32)
        out[f"node.trees.{t}.leaf_logits"] = leaf[t]
        for k in range(depth):
            out[f"node.trees.{t}.gates.{k}"] = gates[t, k]
            out[f"node.trees.{t}.thresh.{k}"] = thresh[t, k : k + 1]
    _dense(out, "bypass", params["bypass"])
    return out


def gcn_state_dict_from_params(params: Mapping[str, Any]) -> StateDict:
    """GCN params -> the reference `SimpleGCN` state dict."""
    out: StateDict = {}
    _dense(out, "lin1", params["lin1"])
    _dense(out, "lin2", params["lin2"])
    return out


def gnn_model_state_dict_from_params(params: Mapping[str, Any]) -> StateDict:
    """The integrated trainer's GNNModel params -> the port's `GNNModel`
    state dict: the same `torch_dense` lin1 / lin2 layout as SimpleGCN's."""
    return gcn_state_dict_from_params(params)


def tower_state_dict(params: Mapping[str, Any]) -> StateDict:
    """Flax `TextTransformer` params -> port `TextTransformer` state dict,
    dense or MoE blocks (`block{i}/moe/{router,w_in,b_in,w_out,b_out}`; the
    expert arrays keep their (E, in, out) layout)."""
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
        if "moe" in p:  # a switch-MoE block: router Dense, stacked experts as they are
            _dense(out, f"{pre}.moe.router", p["moe"]["router"])
            for name in ("w_in", "b_in", "w_out", "b_out"):
                out[f"{pre}.moe.{name}"] = _f32(p["moe"][name])
        else:
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


def semantic_projector_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """Flax `SemanticProjector` variables (or their "params") -> state dict
    of `models/semantic.SemanticProjector`."""
    params = variables.get("params", variables)
    out: StateDict = {}
    _dense(out, "text_dense", params["text_dense"])
    _dense(out, "vision_dense", params["vision_dense"])
    return out


def fusion_state_dict(params: Mapping[str, Any]) -> StateDict:
    # the reference layout adds zero-filled semantic.* entries that only its
    # own strict loader needs; no fusion forward reads them
    sd = fusion_state_dict_from_params(params)
    return {k: v for k, v in sd.items() if not k.startswith("semantic.")}


def port_state_dicts(
    params: Mapping[str, Any],
    align_variables: Optional[Mapping[str, Any]],
    node_tau: float,
) -> Dict[str, StateDict]:
    """The whole JAX tree -> {"fusion", "clf", ["align"], ["gnn"],
    ["text_tower"]} (no "align" when `align_variables` is None: the
    trainer's tree, or its gradients)."""
    out = {
        "fusion": fusion_state_dict(params["fusion"]),
        "clf": classifier_state_dict_from_params(params["clf"], tau=node_tau),
    }
    if align_variables is not None:
        out["align"] = align_state_dict(align_variables)
    if "gnn" in params:
        out["gnn"] = gcn_state_dict_from_params(params["gnn"])
    if "text_tower" in params:
        out["text_tower"] = tower_state_dict(params["text_tower"])
    return out


def ensemble_state_dicts_from_params(
    params: Mapping[str, Any], node_tau: float = 10.0
) -> List[Tuple[StateDict, StateDict]]:
    """The v1 ensemble's stacked {"fusion", "clf"} tree (every leaf with a
    leading (E,) member axis; params or gradients) -> E pairs of
    (fusion, classifier) state dicts, member by member."""
    def member(tree: Mapping[str, Any], e: int) -> Dict[str, Any]:
        return {k: member(v, e) if isinstance(v, Mapping) else np.asarray(v)[e]
                for k, v in tree.items()}

    size = len(np.asarray(params["clf"]["temperature"]))
    return [(fusion_state_dict(member(params["fusion"], e)),
             classifier_state_dict_from_params(member(params["clf"], e), tau=node_tau))
            for e in range(size)]


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


def trained_model(
    out_dir: str, slot: str, align_from: Optional[str] = None
) -> Tuple[Dict[str, Mapping[str, Any]], Dict[str, Any]]:
    """({part: state dict}, meta) of a model directory for the checkpoint
    `<out_dir>/<slot>/` of the port's trainer (`training/checkpoint.read_slot`:
    state.pt and meta.json, whose "model" entry holds the resolved module
    dims), in memory. The temporal align MLP, which the trainer does not
    train, is the one the run's cache was built with, `<out_dir>/align.pt`
    (written by the trainer's cache ladder); a run without one (an injected
    cache) takes it with its dims from the model directory `align_from`.
    A slot of the integrated trainer raises ValueError, as the Predictor
    would (`serving.check_trainer_kind`); so does a JAX out_dir's slot."""
    from ultrafnd_git_tpu_torch.serving import check_trainer_kind
    from ultrafnd_git_tpu_torch.training.checkpoint import read_slot

    payload, ckpt_meta = read_slot(out_dir, slot)
    check_trainer_kind(ckpt_meta.get("trainer", "v2"))
    run_align = load_align(out_dir)
    if run_align is not None:
        align = run_align["state_dict"]
        align_meta = {"in_dim": int(run_align["in_dim"]), "out_dim": int(run_align["out_dim"])}
    elif align_from is not None:
        with open(Path(align_from) / "meta.json", "r", encoding="utf-8") as fh:
            align_meta = json.load(fh)["align"]
        align = torch.load(Path(align_from) / "weights.pt", map_location="cpu",
                           weights_only=True, mmap=True)["align"]
    else:
        raise FileNotFoundError(
            f"{out_dir} carries no align.pt (its cache was injected): pass "
            "align_from, the model directory whose align MLP built that cache")
    meta = {"cfg": ckpt_meta["cfg"], **ckpt_meta["model"], "align": align_meta}
    return {**payload["params"], "align": align}, meta


def export_trained(
    out_dir: str, slot: str, model_dir: str, align_from: Optional[str] = None
) -> Path:
    """A servable model directory from a checkpoint of the port's trainer:
    `trained_model`'s weights.pt and meta.json, and a copy of
    `<out_dir>/feature_cache.npz`, written into `model_dir`."""
    weights, meta = trained_model(out_dir, slot, align_from)
    return write_model_dir(model_dir, weights, meta,
                           cache_npz=str(Path(out_dir) / "feature_cache.npz"))
