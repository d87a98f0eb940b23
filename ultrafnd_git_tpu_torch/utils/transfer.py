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
member by member (`ensemble_state_dicts_from_params`); the edge-list GNNs
of `models/graph_nets.py` by their Flax names (`graph_nets_state_dict`). The
four HF twins of the JAX package (`models/{bert,roberta,w2v2,clip}_flax.py`)
map to the port's twins, whose modules carry HF's key names
(`bert_state_dict`, `roberta_classifier_state_dict`, `w2v2_state_dict`,
`clip_text_state_dict`; an HF `state_dict()` loads into them directly). The
caller converts arrays to numpy.

A reference `best.pt` (`torch.save({"fusion", "clf", "gnn" | None, "cfg"})`,
the layout of the reference's v2 trainer) maps to and from the state dicts
of the port's own trainer, whose fusion, classifier and GCN modules carry
the reference keys: `port_state_dicts_from_best_pt` and
`best_pt_from_port_state_dicts`, which the `import_reference` and
`export_reference` CLIs run.

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
# the reference fusion's semantic analyzer projections: CLIP-width constants
# (512 x 512 whatever the fusion's width), which no fusion forward reads
SEMANTIC_PROJ = ("semantic.text_proj.0", "semantic.vision_proj.0")


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
    _semantic_zeros(out)
    for name in ("attn_tv", "attn_ta", "attn_vu"):
        _coattn(out, name, params[name])
    _dense(out, "fuse_mlp.0", params["fuse0"])
    _dense(out, "fuse_mlp.3", params["fuse1"])
    _dense(out, "classifier", params["head"])
    return out


def _semantic_zeros(out: StateDict) -> None:
    for name in SEMANTIC_PROJ:
        out[f"{name}.weight"] = np.zeros((512, 512), dtype=np.float32)
        out[f"{name}.bias"] = np.zeros((512,), dtype=np.float32)


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


def graph_nets_state_dict(params: Mapping[str, Any]) -> StateDict:
    """Flax `PostEncoder` / `HeteroFGHGNN` / `SAGELayer` params ->
    `models/graph_nets.py`'s state dict: every Dense keeps its Flax name
    (`sage0/self`, `phr1`, `out`, ...) as a `Linear`."""
    out: StateDict = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for name, sub in tree.items():
            if "kernel" in sub:
                _dense(out, prefix + name, sub)
            else:
                walk(sub, f"{prefix}{name}.")

    walk(params, "")
    return out


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


def _embed(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _f32(p["embedding"])


def _conv1d(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    """Flax Conv kernel (k, in / groups, out) -> torch Conv1d (out, in / groups, k)."""
    out[f"{name}.weight"] = _f32(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    if "bias" in p:
        out[f"{name}.bias"] = _f32(p["bias"])


def _bert_layers(out: StateDict, params: Mapping[str, Any]) -> None:
    """`layer{i}` of a Flax `BertLayer` stack -> `encoder.layer.{i}.*`."""
    depth = sum(1 for k in params if k.startswith("layer"))
    for i in range(depth):
        p, pre = params[f"layer{i}"], f"encoder.layer.{i}"
        for flax_name, name in (("query", "attention.self.query"),
                                ("key", "attention.self.key"),
                                ("value", "attention.self.value"),
                                ("attn_out", "attention.output.dense"),
                                ("ffn_in", "intermediate.dense"),
                                ("ffn_out", "output.dense")):
            _dense(out, f"{pre}.{name}", p[flax_name])
        _layer_norm(out, f"{pre}.attention.output.LayerNorm", p["attn_ln"])
        _layer_norm(out, f"{pre}.output.LayerNorm", p["ffn_ln"])


def _bert_embeddings(out: StateDict, params: Mapping[str, Any]) -> None:
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        _embed(out, f"embeddings.{name}", params[name])
    _layer_norm(out, "embeddings.LayerNorm", params["embed_ln"])


def bert_state_dict(params: Mapping[str, Any]) -> StateDict:
    """Flax `BertEncoderFlax` params -> `models/bert.BertEncoder` state dict
    (HF `BertModel` keys): the inverse of `torch_bert_to_flax_params`."""
    out: StateDict = {}
    _bert_embeddings(out, params)
    _bert_layers(out, params)
    return out


def roberta_classifier_state_dict(params: Mapping[str, Any]) -> StateDict:
    """Flax `RobertaClassifierFlax` params -> `models/roberta.RobertaClassifier`
    state dict: the inverse of `torch_roberta_clf_to_flax_params`."""
    out = bert_state_dict(params)
    _dense(out, "classifier.dense", params["cls_dense"])
    _dense(out, "classifier.out_proj", params["cls_out"])
    return out


def w2v2_state_dict(params: Mapping[str, Any]) -> StateDict:
    """Flax `Wav2Vec2EncoderFlax` params -> `models/w2v2.Wav2Vec2Encoder`
    state dict (the positional conv's weight as the materialised
    `encoder.pos_conv_embed.conv.weight`): the inverse of
    `torch_w2v2_to_flax_params`."""
    fe = params["feature_extractor"]
    out: StateDict = {}
    for i in range(sum(1 for k in fe if k.startswith("conv") and k[4:].isdigit())):
        _conv1d(out, f"feature_extractor.conv_layers.{i}.conv", fe[f"conv{i}"])
    _layer_norm(out, "feature_extractor.conv_layers.0.layer_norm", fe["conv0_gn"])
    _layer_norm(out, "feature_projection.layer_norm", params["proj_ln"])
    _dense(out, "feature_projection.projection", params["proj"])
    _conv1d(out, "encoder.pos_conv_embed.conv", params["pos_conv"])
    _layer_norm(out, "encoder.layer_norm", params["encoder_ln"])
    depth = sum(1 for k in params if k.startswith("layer"))
    for i in range(depth):
        p, pre = params[f"layer{i}"], f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, f"{pre}.attention.{name}", p[name])
        _layer_norm(out, f"{pre}.layer_norm", p["attn_ln"])
        _dense(out, f"{pre}.feed_forward.intermediate_dense", p["ffn_in"])
        _dense(out, f"{pre}.feed_forward.output_dense", p["ffn_out"])
        _layer_norm(out, f"{pre}.final_layer_norm", p["ffn_ln"])
    return out


def clip_text_state_dict(params: Mapping[str, Any]) -> StateDict:
    """Flax `ClipTextEncoderFlax` params -> `models/clip.ClipTextEncoder`
    state dict (HF keys without `text_model.`): the inverse of
    `torch_clip_text_to_flax_params`."""
    out: StateDict = {}
    _embed(out, "embeddings.token_embedding", params["token_embedding"])
    _embed(out, "embeddings.position_embedding", params["position_embedding"])
    depth = sum(1 for k in params if k.startswith("layer"))
    for i in range(depth):
        p, pre = params[f"layer{i}"], f"encoder.layers.{i}"
        _layer_norm(out, f"{pre}.layer_norm1", p["ln1"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, f"{pre}.self_attn.{name}", p[name])
        _layer_norm(out, f"{pre}.layer_norm2", p["ln2"])
        _dense(out, f"{pre}.mlp.fc1", p["fc1"])
        _dense(out, f"{pre}.mlp.fc2", p["fc2"])
    _layer_norm(out, "final_layer_norm", params["final_ln"])
    out["text_projection.weight"] = _f32(np.asarray(params["text_projection"]["kernel"]).T)
    return out


def port_state_dicts_from_best_pt(payload: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A reference `best.pt` payload -> the port's {"fusion", "clf",
    ["gnn"]} state dicts, tensors as they are. The fusion loses its
    zero-filled `semantic.{text,vision}_proj.0.*` entries and nothing else,
    so a strict load into the port's modules checks every other key and
    shape. No "gnn" when the payload's is None (use_gnn=False) or absent.
    The classifier keeps the file's `node.trees.{t}.tau`; the forest
    computes with its config's node_tau, as the JAX package's
    (`v2_params_from_best_pt` reads no tau)."""
    semantic = tuple(f"{name}." for name in SEMANTIC_PROJ)
    out = {
        "fusion": {k: torch.as_tensor(v) for k, v in payload["fusion"].items()
                   if not k.startswith(semantic)},
        "clf": {k: torch.as_tensor(v) for k, v in payload["clf"].items()},
    }
    if payload.get("gnn") is not None:
        out["gnn"] = {k: torch.as_tensor(v) for k, v in payload["gnn"].items()}
    return out


def best_pt_from_port_state_dicts(
    state_dicts: Mapping[str, Mapping[str, Any]], node_tau: float
) -> Dict[str, Optional[Dict[str, torch.Tensor]]]:
    """The port's {"fusion", "clf", ["gnn"]} state dicts -> the reference
    `best.pt` trio {"fusion", "clf", "gnn" | None}: the fusion with the
    zero-filled `semantic.*` 512 x 512 entries the reference's strict
    loader needs; every `node.trees.{t}.tau` set to `node_tau`, 0-d;
    "gnn" None without a GCN, as the reference writes under use_gnn=False.
    The caller adds "cfg"."""
    def tensors(sd):
        return {k: torch.as_tensor(v).detach().cpu().contiguous() for k, v in sd.items()}

    semantic: StateDict = {}
    _semantic_zeros(semantic)
    fusion = {**tensors(state_dicts["fusion"]),
              **{k: torch.from_numpy(v) for k, v in semantic.items()}}
    clf = tensors(state_dicts["clf"])
    for k in clf:
        if k.startswith("node.trees.") and k.endswith(".tau"):
            clf[k] = torch.tensor(float(node_tau), dtype=torch.float32)
    gnn = state_dicts.get("gnn")
    return {"fusion": fusion, "clf": clf, "gnn": None if gnn is None else tensors(gnn)}


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
