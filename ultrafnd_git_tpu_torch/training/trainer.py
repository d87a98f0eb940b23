"""The cache-based v2 trainer (counterpart of `training/trainer.py`).

    trainer = ForensicTrainer(TrainConfig(data_root=R, out_dir=O,
                                          train_text_tower=True))
    trainer.fit()                 # epochs of train + val, best/latest slots
    results = trainer.test()      # the JAX trainer's test_* keys

Feature cache -> transductive OCR-Jaccard graph + GCN (trained in the
step, the `out_rows` shortcut; dense (N, N) `a_norm`, or with
`sparse_graph` padded (N, K) neighbour lists and no (N, N) object, as the
JAX trainer's `--sparse_graph`) -> optional trainable text tower (its
attention on K2, K3 and K4 on a GPU) -> fusion (its evidence gates fed the
cache's scorer outputs under `use_evidence`, as the JAX trainer's
`trainer.py:450-451`, `:875-876`; the internal proxies otherwise) -> NODE
classifier; masked
mean cross-entropy, `grad_accum` as a sum of microbatch gradients over the
step's valid rows, AdamW with global-norm clipping and the epoch-staircase
schedule (K1 on a GPU), early stop on the validation
metric, `best` / `latest` checkpoints, `--resume` and `--eval_only` with
the JAX trainer's checkpoint-field adoption. The batch orders are the JAX
trainer's: `np.random.seed(cfg.seed)` then one shuffle per epoch.

`bf16_compute` is the JAX trainer's (`trainer.py:536-542`, `:598`): the
fusion, the classifier and the tower compute in bf16 (`dtype=torch.bfloat16`,
Flax's casts, `models/layers.py`), so on a GPU the tower's attention runs
K2's and K3/K4's bf16 modes in training, val and test alike; the GCN, the
params, their gradients, the AdamW state (K1) and the checkpoints stay f32,
and the cross-entropy is taken on the classifier's f32 logits. One known
difference: JAX's `flash_attention(backend="auto")` sends S < 512 to XLA's
`reference_attention` (`kernels/flash_attention.py:529-533`), whose
softmax runs in bf16, so at the tower's S = 64 the JAX trainer never runs
the Pallas bf16 backward, on a TPU or on the CPU; the port sends every S
to its kernels (ROADMAP.md's ground rules). The tests hold the port's
bf16 tower and step to a JAX tower cloned with
`attention_backend="interpret"`, which runs the Pallas bf16 forward and
backward.

The feature cache comes from `data/cache.bootstrap_cache`: injected >
out_dir's own > a model directory's (`model_dir`, from
`scripts/export_torch_model.py` or the port's exports) > built from the raw
`data_root` (FileNotFoundError without its data_complete.json), the salt
set before the build as the JAX trainer sets it (`trainer.py:362`). The
align MLP the cache was built with goes into `<out_dir>/align.pt`, where
`export_trained` finds it. The featurization of new records must follow the
corpus: when the cache is taken from `model_dir`, the run adopts that
directory's `hash_salt` and `ocr_phrase_pkl` (its meta.json cfg), and its
checkpoints (and so `export_trained`) carry them.

Differences that are the port's own: one step per Python call (no
`lax.scan`, so `scan_epoch` has no effect), one `torch.Generator` for the
dropout masks (so `fast_dropout_rng` has no effect), one AdamW route (K1
is bit-identical to the plain update, so `fused_adamw` has no effect and
every run launches K1 on a GPU), parameters drawn from
the JAX package's distributions but not its numbers, no GCN when
`use_gnn=False` (the JAX trainer builds and weight-decays one it never
uses), and a cache built from `data_root` has the port's own align draw
(`models/temporal.TemporalSyncNet`). The fusion and classifier are built
from `fusion_config` / `classifier_config` (flat YAML, `utils/config.py`),
with the keys and defaults of the JAX modules' `from_config`; their dims
go into every slot's meta "model".

Every single-device field of the JAX `TrainConfig` trains: `moe_experts`
swaps the tower's MLPs for switch-MoE FFNs (`models/moe.py`), whose aux
loss joins every row's loss under `moe_aux_weight` in train and eval alike;
`remat_tower` rematerialises each tower block (`torch.utils.checkpoint`,
the dropout masks drawn before it, so the bits do not move);
`save_every_steps` also writes the `latest` slot every K optimizer steps
of an epoch but its last, with the JAX meta (`in_epoch`, `step_cursor`,
`epoch_order`, `np_random_state`), and `--resume` re-enters that epoch at
the cursor in the saved order, bit for bit the uninterrupted run;
`profile_dir` writes a torch.profiler trace of `fit()` with the program's
spans (`utils/spans.py`: the step's upload, forward by stage, backward and
optimizer) as a track of their own; `debug_nans`
raises FloatingPointError at the first step whose loss, outputs or
gradients hold a NaN.

The mesh fields train as the JAX trainer's (`parallel/mesh.py`): `dp`,
`tp` and `dcn` lay the world's ranks out as ([dcn,] data, model), one
process a rank (`--multihost`, or a caller's own process group; a mesh of
one starts a local group itself). Every rank computes the same global
batches from the same seeded stream and keeps its rows; the masked means
divide by the global batch's count and the gradients are summed over the
data axes (within 'data', then across 'dcn'); the dropout masks are the
global batch's, cut to the rank's rows (and columns between the layers of
a tensor-parallel pair), so a mesh trains the function one device trains.
Under `tp` the fusion and classifier MLP pairs hold Megatron shards and
K1's clip takes the norm of the logical parameters. `shard_corpus` and
`shard_graph` keep a rank's 1/D of the corpus rows or of the graph's rows
(replicated when N does not divide), and each step's rows come to every
rank by "owner fills, all-reduce sums". Val and test outputs are assembled
on every rank before the metrics, so they are the global batch's. Rank 0
alone writes checkpoints (the tp shards gathered, in the one-device
format), metrics.jsonl, the feature cache and the profile; `--resume`
re-shards.

`sp` and `pp` transform the text tower on a further mesh axis, as the JAX
trainer's (`trainer.py:383-427`, `:810-860`), its batch on 'data':
`sp` runs it as `parallel/sequence.sequence_parallel_tower_apply` (its
sequence split over the `sp` ranks, attention as a ring), `pp` as
`parallel/pipeline.pipelined_tower_apply` (GPipe over the `pipe` ranks,
`pp_microbatches` microbatches, default pp). Both need
`train_text_tower`, exclude `moe_experts`, each other and `dcn`, and `pp`
divides the depth (JAX's errors and their text). A leaf whose gradient
each rank holds only in part is summed over `sp` or `pipe` as well as
the data axes: every tower leaf under sp; the blocks and the embedding
under pp. The fusion, classifier and GCN, and ln_final under pp, are
computed whole on every rank and are not. The dropout masks are the plain
tower's (`models/dropout.py`), so an sp or pp step trains what one device
trains and K1's clip takes the plain global norm on every rank.
`remat_tower` has no effect under sp and pp, as in JAX.
"""
from __future__ import annotations

import copy
import json
import math
import os
import time
from contextlib import nullcontext
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.data.cache import TOWER_VOCAB, bootstrap_cache
from ultrafnd_git_tpu_torch.kernels.adamw import FusedAdamW
from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
from ultrafnd_git_tpu_torch.models.dropout import ShardedGenerator
from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer
from ultrafnd_git_tpu_torch.models.gnn import SimpleGCN
from ultrafnd_git_tpu_torch.models.initializers import jax_init_
from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
from ultrafnd_git_tpu_torch.ops.graphctx import build_graph_context, build_sparse_graph_context
from ultrafnd_git_tpu_torch.ops.hashing import set_hash_salt
from ultrafnd_git_tpu_torch.parallel import collectives as coll
from ultrafnd_git_tpu_torch.parallel import mesh as meshlib
from ultrafnd_git_tpu_torch.parallel.pipeline import pipelined_tower_apply
from ultrafnd_git_tpu_torch.parallel.sequence import sequence_parallel_tower_apply
from ultrafnd_git_tpu_torch.training import checkpoint as ckpt
from ultrafnd_git_tpu_torch.training.loop import (
    ImprovementTracker,
    flatten_epoch_rows,
    iter_padded_batches,
    load_checkpoint_guarded,
    log_jsonl,
    np_random_state_payload,
    profiler_trace,
    restore_np_random_state,
)
from ultrafnd_git_tpu_torch.training.metrics import aggregate_epoch_metrics, pretty_print
from ultrafnd_git_tpu_torch.training.state import TrainState, make_optimizer
from ultrafnd_git_tpu_torch.utils.config import classifier_config, fusion_config
from ultrafnd_git_tpu_torch.utils.device import resolve_device, to_device
from ultrafnd_git_tpu_torch.utils.spans import span

GNN_DROPOUT = 0.2
CACHE_SOURCES = ("injected", "out_dir", "model_dir", "data_root")
MOE_CAPACITY_FACTOR = 1.25  # the JAX tower's moe_capacity_factor (no TrainConfig field)
TRAINER_KIND = "v2"


@dataclass
class TrainConfig:
    """The JAX `TrainConfig` (`trainer.py:65-258`): same field names and
    defaults, plus `model_dir`, a model directory whose feature cache (and
    align weights) the run may take instead of building one from
    `data_root`. `scan_epoch`, `fast_dropout_rng` and `fused_adamw` are accepted (and
    adopted from a checkpoint, and written to its meta) and have no
    effect. `mesh_backend="cpu"` (JAX: a mesh over the host devices) runs
    the ranks on the CPU over gloo."""

    data_root: Optional[str] = None
    ocr_phrase_pkl: Optional[str] = None
    out_dir: str = "outputs"
    batch_size: int = 16
    epochs: int = 8
    lr: float = 2e-4
    weight_decay: float = 1e-4
    gnn_dim: int = 128
    gnn_overlap_thresh: float = 0.12
    seed: int = 42
    use_gnn: bool = True
    train_gnn: bool = True
    use_evidence: bool = False
    train_text_tower: bool = False
    text_tower_depth: int = 2
    text_tower_heads: int = 6
    tower_gelu: str = "tanh"
    moe_experts: int = 0
    moe_aux_weight: float = 1e-2
    sp: int = 1
    pp: int = 1
    pp_microbatches: Optional[int] = None
    remat_tower: bool = False
    save_best: bool = True
    grad_clip: float = 5.0
    early_stop_patience: int = 3
    select_metric: str = "auc"
    hash_salt: str = ""
    cache_to_disk: bool = True
    resume: bool = False
    save_every_steps: int = 0
    eval_only: bool = False
    dp: Optional[int] = None
    tp: int = 1
    dcn: int = 1
    shard_corpus: bool = False
    shard_graph: bool = False
    sparse_graph: bool = False
    mesh_backend: Optional[str] = None
    bf16_compute: bool = False
    scan_epoch: bool = True
    grad_accum: int = 1
    fused_adamw: bool = False
    fast_dropout_rng: bool = True
    profile_dir: Optional[str] = None
    debug_nans: bool = False
    log_metrics_jsonl: bool = True
    fusion_config: str = "configs/model_configs/fusion.yaml"
    classifier_config: str = "configs/model_configs/classifier.yaml"
    model_dir: Optional[str] = None


def _check_tower_transforms(cfg: TrainConfig) -> None:
    """The JAX trainer's checks of --sp and --pp (`trainer.py:383-410`),
    in its order and with its text."""
    for flag, val in (("--sp", cfg.sp), ("--pp", cfg.pp)):
        if val > 1:
            if not cfg.train_text_tower:
                raise ValueError(f"{flag} transforms the text tower; it requires "
                                 "--train_text_tower")
            if cfg.moe_experts > 0:
                raise ValueError(f"{flag} and --moe_experts are mutually exclusive "
                                 "(the transformed tower has a dense MLP body)")
    if cfg.sp > 1 and cfg.pp > 1:
        raise ValueError("--sp and --pp are mutually exclusive (one tower "
                         "transform at a time; they compose with --dp/--tp)")
    if cfg.pp > 1 and cfg.text_tower_depth % cfg.pp:
        raise ValueError(f"tower depth {cfg.text_tower_depth} not divisible by pp={cfg.pp}")
    if cfg.dcn > 1 and (cfg.sp > 1 or cfg.pp > 1):
        raise ValueError(
            "--dcn composes with --dp/--tp only: the sp/pp shard_map "
            "bodies address the batch by the single 'data' axis (ring "
            "and pipeline stay within a slice by design)"
        )


def _uses_mesh(cfg: TrainConfig) -> bool:
    return cfg.dp is not None or cfg.tp > 1 or cfg.dcn > 1 or cfg.sp > 1 or cfg.pp > 1


def module_configs(cfg, text_width: int, widths: Dict[str, int]):
    """(CrossModalTransformer kwargs but dtype, DeepTruthClassifier kwargs
    but in_dim and dtype) from `cfg.fusion_config` and
    `cfg.classifier_config` (`utils/config.py`), as the JAX trainers build
    them (`CrossModalTransformer.from_config`, then use_gnn off without
    the trainer's; the GCN's width is the trainer's gnn_dim)."""
    fusion = fusion_config(cfg.fusion_config)
    fusion_kw = dict(hidden=fusion["hidden"], text_dim=int(text_width),
                     **{f"{k}_dim": int(widths[k]) for k in ("audio", "visual", "temporal")},
                     use_gnn=bool(fusion["use_gnn"] and cfg.use_gnn), gnn_dim=int(cfg.gnn_dim),
                     dropout=fusion["dropout"])
    return fusion_kw, classifier_config(cfg.classifier_config)


def _raise_on_nan(where: str, *tensors: torch.Tensor) -> None:
    """FloatingPointError when any of `tensors` holds a NaN (debug_nans:
    one device sync for all of them). Like jax_debug_nans, inf passes."""
    if torch.stack([t.detach().isnan().any() for t in tensors]).any().item():
        raise FloatingPointError(f"debug_nans: a NaN in the {where}")


def _adopt_checkpoint_fields(cfg: TrainConfig) -> None:
    """The JAX trainer's adoption (`trainer.py:273-353`): with --resume
    (latest) or --eval_only (best), the fields that shape the trained
    function or its optimizer state come from the slot's meta."""
    slot = "latest" if cfg.resume else ("best" if cfg.eval_only else None)
    if slot is None:
        return
    meta_p = os.path.join(cfg.out_dir, slot, "meta.json")
    saved: Dict[str, Any] = {}
    if os.path.exists(meta_p):
        try:
            with open(meta_p, "r", encoding="utf-8") as fh:
                saved = json.load(fh).get("cfg", {})
        except (OSError, ValueError):
            saved = {}
    if saved.get("train_text_tower") and not cfg.train_text_tower:
        print("note: checkpoint was trained with --train_text_tower; adopting it")
        cfg.train_text_tower = True
    if saved.get("train_text_tower"):
        for field, default in (("text_tower_depth", 2), ("text_tower_heads", 12),
                               ("moe_experts", 0)):
            saved_v = int(saved.get(field, default))
            if saved_v != getattr(cfg, field):
                print(f"note: checkpoint tower was trained with {field}={saved_v}; "
                      "adopting it")
                setattr(cfg, field, saved_v)
        saved_gelu = str(saved.get("tower_gelu", "exact"))
        if saved_gelu != cfg.tower_gelu:
            print(f"note: checkpoint tower was trained with tower_gelu={saved_gelu}; "
                  "adopting it")
            cfg.tower_gelu = saved_gelu
    # bf16_compute too: the slot's function was trained (and is scored) in
    # that arithmetic
    for field, default in (("train_gnn", True), ("fused_adamw", False), ("bf16_compute", False)):
        if saved and bool(saved.get(field, default)) != getattr(cfg, field):
            print(f"note: checkpoint was trained with {field}="
                  f"{saved.get(field, default)}; adopting it")
            setattr(cfg, field, bool(saved.get(field, default)))
    if saved and saved.get("hash_salt", "") != cfg.hash_salt:
        print(f"note: checkpoint was trained with hash_salt="
              f"{saved.get('hash_salt', '')!r}; adopting it")
        cfg.hash_salt = str(saved.get("hash_salt", ""))


def _adopt_model_dir_fields(cfg: TrainConfig) -> None:
    """The featurization fields of the corpus whose cache this run took from
    `model_dir` (its meta.json cfg): new records must be hashed under the
    same salt and their OCR tokenized the same way (the exported cfg tells
    the Predictor how)."""
    saved: Dict[str, Any] = {}
    try:
        with open(Path(cfg.model_dir) / "meta.json", "r", encoding="utf-8") as fh:
            saved = json.load(fh).get("cfg", {})
    except (OSError, ValueError):
        saved = {}
    for field, default in (("hash_salt", ""), ("ocr_phrase_pkl", None)):
        value = saved.get(field, default)
        if saved and value != getattr(cfg, field):
            print(f"note: the cache of {cfg.model_dir} was featurized with "
                  f"{field}={value!r}; adopting it")
            setattr(cfg, field, value)


class ForensicTrainer:
    """Cache-based multimodal trainer with a transductive GCN channel.

    `device` is "cuda" by default and raises without a GPU; pass "cpu" to
    run the plain versions of the kernels on the CPU.
    """

    def __init__(self, cfg: TrainConfig, cache: Optional[Dict[str, Any]] = None,
                 device: str = "cuda"):
        self.cfg = cfg
        os.makedirs(cfg.out_dir, exist_ok=True)
        _adopt_checkpoint_fields(cfg)
        _check_tower_transforms(cfg)
        if cfg.tower_gelu not in ("tanh", "exact"):
            raise ValueError(f"tower_gelu must be 'tanh' or 'exact', got {cfg.tower_gelu!r}")
        self.device = dev = resolve_device("cpu" if cfg.mesh_backend == "cpu" else device)
        # ---- mesh (optional): this rank's place in ([dcn,] data, model) -----
        self.mesh: Optional[meshlib.Mesh] = None
        if _uses_mesh(cfg):
            extra = [(meshlib.SP_AXIS, cfg.sp)] if cfg.sp > 1 else []
            extra += [(meshlib.PIPE_AXIS, cfg.pp)] if cfg.pp > 1 else []
            self.mesh = meshlib.make_mesh(cfg.dp, cfg.tp, cfg.dcn, device=dev,
                                          extra_axes=extra)
            self.device = dev = resolve_device(str(self.mesh.device))
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dp = meshlib.data_parallel_size(self.mesh)
            if cfg.batch_size % dp:
                raise ValueError(
                    f"batch_size {cfg.batch_size} does not divide over the {dp} "
                    "data-parallel ranks (each takes batch_size / dp rows of a batch)")
        mesh = self.mesh
        self._data = mesh.shard(*meshlib.data_axes(mesh)) if mesh is not None else None
        self._tp = (mesh.shard(meshlib.MODEL_AXIS)
                    if mesh is not None and mesh.shape[meshlib.MODEL_AXIS] > 1 else None)
        # the tower's transform axis under --sp / --pp
        self._sp = mesh.shard(meshlib.SP_AXIS) if cfg.sp > 1 else None
        self._pipe = mesh.shard(meshlib.PIPE_AXIS) if cfg.pp > 1 else None
        np.random.seed(cfg.seed)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        # ---- feature cache and device-resident corpus ----------------------
        # the salt is live before any featurization (the cache build, its
        # fingerprint)
        set_hash_salt(cfg.hash_salt)
        self.cache, self.cache_source = self._bootstrap_cache(cache)
        if self.cache_source == "model_dir":
            _adopt_model_dir_fields(cfg)
            set_hash_salt(cfg.hash_salt)
        self.tr_idx, self.va_idx, self.te_idx = (np.asarray(s) for s in self.cache["split"])
        self.n_total = int(self.cache["labels"].shape[0])

        # the first row of each corpus array whose rows are split over the
        # data axes (shard_corpus / shard_graph), by key
        self._owned: Dict[str, int] = {}

        def put(key, x, dtype=torch.float32, split=False):
            arr = np.asarray(x)
            rows = meshlib.owned_rows(arr.shape[0], mesh) if split and mesh is not None else None
            if rows is not None:
                arr = arr[rows]
                self._owned[key] = rows.start
            return torch.as_tensor(arr).to(dev, dtype)

        split = cfg.shard_corpus
        self.corpus: Dict[str, torch.Tensor] = {
            k: put(k, self.cache[k], split=split) for k in ("audio", "visual", "temporal", "aux")
        }
        self.corpus["labels"] = put("labels", self.cache["labels"], torch.int64, split)
        if cfg.use_evidence and "evidence" in self.cache:
            self.corpus["evidence"] = put("evidence", self.cache["evidence"], split=split)
        text_width = int(self.cache["text"].shape[1])
        if cfg.train_text_tower:
            if float(np.asarray(self.cache["text_mask"]).sum()) == 0.0:
                raise ValueError("--train_text_tower needs token ids, but this cache has none")
            length = int(self.cache["text_ids"].shape[1])
            if cfg.sp > 1 and length % cfg.sp:
                raise ValueError(f"tower token length {length} not divisible by sp={cfg.sp}")
            self.corpus["text_ids"] = put("text_ids", self.cache["text_ids"], torch.int64, split)
            self.corpus["text_mask"] = put("text_mask", self.cache["text_mask"], split=split)
        else:
            self.corpus["text"] = put("text", self.cache["text"], split=split)
        split = cfg.shard_graph
        if cfg.use_gnn and cfg.sparse_graph:
            sctx = build_sparse_graph_context(self.cache, cfg.gnn_overlap_thresh)
            self.corpus["nbr_idx"] = put("nbr_idx", sctx.nbr_idx, torch.int64, split)
            self.corpus["nbr_w"] = put("nbr_w", sctx.nbr_w, split=split)
            self.corpus["ax"] = put("ax", sctx.ax)
        elif cfg.use_gnn:
            gctx = build_graph_context(self.cache, cfg.gnn_overlap_thresh)
            self.corpus["a_norm"] = put("a_norm", gctx.a_norm, split=split)
            self.corpus["ax"] = put("ax", gctx.ax)

        # ---- modules (the JAX package's initial distributions) -------------
        widths = {k: int(self.cache[k].shape[1]) for k in ("audio", "visual", "temporal")}
        # bf16-compute / f32-master (JAX trainer.py:536-542, :598); the GCN stays f32
        dtype = torch.bfloat16 if cfg.bf16_compute else None
        fusion_kw, clf_kw = module_configs(cfg, text_width, widths)
        self.model_meta: Dict[str, Any] = {
            "fusion": {k: v for k, v in fusion_kw.items() if k != "dropout"},
            "classifier": {k: v for k, v in clf_kw.items() if k not in ("dropout", "node_dropout")},
            "gnn": None,
            "text_tower": None,
        }
        params: Dict[str, nn.Module] = {
            "fusion": CrossModalTransformer(**fusion_kw, dtype=dtype),
            "clf": DeepTruthClassifier(in_dim=fusion_kw["hidden"], **clf_kw, dtype=dtype),
        }
        if cfg.use_gnn:
            in_dim = int(self.corpus["ax"].shape[1])
            params["gnn"] = SimpleGCN(in_dim, 2 * cfg.gnn_dim, cfg.gnn_dim, GNN_DROPOUT)
            self.model_meta["gnn"] = {"in_dim": in_dim, "hid": 2 * cfg.gnn_dim,
                                      "out_dim": cfg.gnn_dim}
        if cfg.train_text_tower:
            tower = dict(width=text_width, depth=cfg.text_tower_depth,
                         heads=cfg.text_tower_heads, vocab_size=TOWER_VOCAB,
                         max_len=int(self.cache["text_ids"].shape[1]),
                         gelu=cfg.tower_gelu, moe_experts=cfg.moe_experts,
                         moe_capacity_factor=MOE_CAPACITY_FACTOR)
            params["text_tower"] = TextTransformer(**tower, dtype=dtype,
                                                   remat=cfg.remat_tower)
            self.model_meta["text_tower"] = tower
        init_gen = torch.Generator().manual_seed(cfg.seed)  # same draws on any device
        for part, mod in params.items():
            jax_init_(part, mod, init_gen).to(dev)
        if self._tp is not None:  # the full draws, then this rank's shards
            meshlib.shard_modules_(params, self._tp)
        if mesh is not None and cfg.moe_experts > 0:  # route the global batch
            for block in params["text_tower"].blocks:
                block.moe.dp = self._data

        if cfg.use_gnn and not (cfg.eval_only and ckpt.checkpoint_exists(cfg.out_dir, "best")):
            self._pretrain_gnn(params["gnn"], gen)

        # ---- optimizer and state -------------------------------------------
        steps_per_epoch = max(
            1, math.ceil(len(self.tr_idx) / (cfg.batch_size * max(1, cfg.grad_accum)))
        )
        self.tx = make_optimizer(
            cfg.lr, cfg.weight_decay, cfg.grad_clip, steps_per_epoch,
            frozen_subtrees=() if cfg.train_gnn else ("gnn",),
        )
        if self._tp is not None:
            self.tx.shard_norm([(part, name) for part, mod in params.items()
                                for name, _ in mod.named_parameters()
                                if meshlib.split_dim(part, name) is not None], self._tp)
        self.state = TrainState(step=0, params=params, opt_state=self.tx.init(params),
                                gen=gen, tp=self._tp)
        self.start_epoch = 1
        self.best_val_auc = -1.0
        self.no_improve = 0
        # mid-epoch resume (save_every_steps slots): the optimizer steps of
        # start_epoch already taken, and that epoch's batch order
        self._resume_cursor = 0
        self._resume_order: Optional[np.ndarray] = None
        if cfg.resume:
            restored = load_checkpoint_guarded(cfg.out_dir, "latest", TRAINER_KIND,
                                               "starting fresh", dev)
            if restored is not None:
                payload, meta = restored
                try:
                    self.state.load_state_dict(payload)
                except ValueError as exc:
                    print(f"⚠️  latest checkpoint does not fit this model ({exc}); "
                          "starting fresh")
                else:
                    if meta.get("in_epoch"):
                        # re-enter the same epoch at the cursor, in its order
                        self.start_epoch = int(meta.get("epoch", 1))
                        self._resume_cursor = int(meta.get("step_cursor", 0))
                        self._resume_order = np.asarray(meta["epoch_order"], np.int32)
                    else:
                        self.start_epoch = int(meta.get("epoch", 0)) + 1
                    self.best_val_auc = float(meta.get("best_val_auc", -1.0))
                    self.no_improve = int(meta.get("no_improve", 0))
                    rs = meta.get("np_random_state")
                    if rs is not None:
                        restore_np_random_state(rs)

    def _bootstrap_cache(self, cache):
        """`data/cache.bootstrap_cache` with this run's fields. On a mesh
        rank 0 goes first (it alone builds, copies or writes out_dir's
        cache); one all-reduce then hands every rank its source, and the
        others take the same cache (out_dir's copy when rank 0 wrote one)."""
        cfg, mesh = self.cfg, self.mesh

        def boot():
            return bootstrap_cache(
                cfg.out_dir, cfg.model_dir, cache, cfg.cache_to_disk,
                # a restored checkpoint was trained on the out_dir's cache
                reuse_stale_features=bool(cfg.eval_only or cfg.resume),
                data_root=cfg.data_root, ocr_phrase_pkl=cfg.ocr_phrase_pkl, seed=cfg.seed,
                device=str(self.device))

        if mesh is None:
            return boot()
        got = boot() if mesh.rank == 0 else None
        code = torch.zeros(1, dtype=torch.int64, device=self.device)
        if got is not None:
            code[0] = CACHE_SOURCES.index(got[1]) + 1
        coll.all_reduce_(code, mesh.shard(*mesh.axis_names))
        if got is None:
            got = (boot()[0], CACHE_SOURCES[int(code.item()) - 1])
        return got

    # ------------------------------------------------------------------
    def pretrain_loss(self, gnn: SimpleGCN, head: torch.Tensor,
                      gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Degree reconstruction over the full graph: mean squared error of
        sigmoid(gcn(x) @ head) against the normalised degree (a row's sum of
        a_norm, or of its neighbour weights under sparse_graph: the same
        nonzeros). With the graph's rows split over the data axes
        (shard_graph) it is this rank's share: its rows' squared errors over
        N, whose sum over the ranks is the loss."""
        c = self.corpus
        if self.cfg.sparse_graph:
            deg = c["nbr_w"].sum(dim=-1, keepdim=True)
            z = gnn.propagate_sparse(c["nbr_idx"], c["nbr_w"], c["ax"], gen)
        else:
            deg = c["a_norm"].sum(dim=-1, keepdim=True)
            z = gnn.propagate(c["a_norm"], c["ax"], gen)
        target = deg / max(1.0, float(self.n_total))
        err = (torch.sigmoid(z @ head) - target) ** 2
        if self._graph_split():
            return err.sum() / float(self.n_total)
        return err.mean()

    def _graph_split(self) -> bool:
        return "a_norm" in self._owned or "nbr_w" in self._owned

    def _pretrain_gnn(self, gnn: SimpleGCN, gen: torch.Generator, epochs: int = 2) -> None:
        """Degree-reconstruction warm start with a fixed random readout head
        and adamw(1e-3, wd=1e-4) in optax order (`trainer.py:731-791`)."""
        dim = self.cfg.gnn_dim
        head = torch.randn((dim, 1), generator=gen, device=self.device) / dim ** 0.5
        opt = FusedAdamW(lambda count: 1e-3, weight_decay=1e-4, grad_clip=0.0)
        params = {"gnn": gnn}
        state = opt.init(params)
        names = [n for n, _ in gnn.named_parameters()]
        for _ in range(epochs):
            loss = self.pretrain_loss(gnn, head, gen)
            grads = torch.autograd.grad(loss, list(gnn.parameters()))
            if self._graph_split():  # each rank's rows' share, summed
                coll.all_reduce_coalesced_(grads, self._data)
            opt.apply(params, state, {"gnn": dict(zip(names, grads))})

    # ------------------------------------------------------------------
    def _forward(self, params: Dict[str, nn.Module], idx: torch.Tensor,
                 gen=None, rows: Optional[Dict[str, torch.Tensor]] = None):
        """(per-row loss (B,), p_fake (B,), forensic (3, B)) of corpus rows
        `idx`; `gen` = None is eval mode, a generator turns dropout on. The
        loss is the CE, plus moe_aux_weight times the tower's Switch aux on
        every row of a MoE tower (`trainer.py:912-916`: the masked mean
        then gains it once a step). On a mesh `idx` are this rank's rows,
        `gen` a `ShardedGenerator`, and `rows` holds those rows of the
        corpus arrays split over the data axes."""
        c, cfg = self.corpus, self.cfg

        def get(key):
            return rows[key] if rows is not None and key in rows else c[key][idx]

        moe_aux = None
        with span("forward.text_tower"):
            if "text_tower" in params and self._sp is not None:
                text = sequence_parallel_tower_apply(params["text_tower"], get("text_ids"),
                                                     get("text_mask"), self._sp, gen)
            elif "text_tower" in params and self._pipe is not None:
                text = pipelined_tower_apply(params["text_tower"], get("text_ids"),
                                             get("text_mask"), self._pipe, cfg.pp_microbatches,
                                             self._data, gen)
            elif "text_tower" in params:
                text = params["text_tower"](get("text_ids"), get("text_mask"), gen,
                                            return_aux=cfg.moe_experts > 0)
                if cfg.moe_experts > 0:
                    text, moe_aux = text
            else:
                text = get("text")
        gnn_feat = None
        if cfg.use_gnn:
            # the corpus hidden is not split by batch rows: the plain generator
            g = gen.gen if isinstance(gen, ShardedGenerator) else gen
            # frozen-GNN mode: no backward through the graph channel
            with span("forward.gnn"), nullcontext() if cfg.train_gnn else torch.no_grad():
                if cfg.sparse_graph:
                    gnn_feat = params["gnn"].propagate_sparse(
                        get("nbr_idx"), get("nbr_w"), c["ax"], g)
                else:
                    gnn_feat = params["gnn"].propagate(get("a_norm"), c["ax"], g)
        with span("forward.fusion"):
            feats = {
                "text_features": text,
                "audio_features": get("audio"),
                "visual_features": get("visual"),
                "temporal_features": get("temporal"),
            }
            if "evidence" in c:
                feats["evidence"] = get("evidence")
            if gnn_feat is not None:
                feats["gnn_feat"] = gnn_feat
            fo = params["fusion"](feats, gen)
        with span("forward.classifier"):
            co = params["clf"](fo["fused"], get("aux"), gen)
        with span("forward.loss"):
            # the logits are f32 under bf16_compute too (the forest and bypass
            # stay f32), as optax's CE takes them (trainer.py:909)
            ce = F.cross_entropy(co["logits"], get("labels"), reduction="none")
            if moe_aux is not None:
                ce = ce + cfg.moe_aux_weight * moe_aux
            f = fo["forensic"]
            forensic = torch.stack(
                [f["semantic_conflict"], f["temporal_delay"], f["emotion_intensity"]]
            )
        return ce, co["probs"][:, 1], forensic

    def trainable(self) -> Dict[str, nn.Module]:
        return {k: m for k, m in self.state.params.items() if k not in self.tx.frozen}

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch (all of it without a mesh)."""
        return t if self.mesh is None else meshlib.put_global_batch(t, self.mesh)

    def _split_rows(self, idx: torch.Tensor) -> Optional[Dict[str, torch.Tensor]]:
        """This rank's rows `idx` (global row ids of the global batch) of the
        corpus arrays split over the data axes: every rank fills the rows it
        holds, one all-reduce a dtype sums them. None when nothing is split."""
        if not self._owned:
            return None
        keys = list(self._owned)
        full = coll.owner_gather([self.corpus[k] for k in keys],
                                 [self._owned[k] for k in keys], idx, self._data)
        return {k: self._local(t) for k, t in zip(keys, full)}

    def _mesh_gen(self, gen):
        """On a mesh, `gen` drawing the global batch's masks and keeping this
        rank's rows."""
        if gen is None or self.mesh is None:
            return gen
        return ShardedGenerator(gen, rows=(self._data.rank, self._data.size))

    def _reduce_grads(self, grads) -> None:
        """Sum the gradients over the data axes in place: within 'data', then
        across 'dcn' (one all-reduce each, the leaves packed once); first,
        the tower leaves each rank holds in part over `sp` or `pipe` (all
        of them under sp, all but ln_final under pp)."""
        mesh = self.mesh
        axis = self._sp or self._pipe
        if axis is not None and "text_tower" in grads:
            coll.all_reduce_coalesced_(
                [g for name, g in grads["text_tower"].items()
                 if self._sp is not None or not name.startswith("ln_final.")], axis)
        axes = [meshlib.DATA_AXIS] + ([meshlib.DCN_AXIS] if meshlib.DCN_AXIS in mesh.axis_names
                                      else [])
        coll.all_reduce_coalesced_([g for d in grads.values() for g in d.values()],
                                   *(mesh.shard(a) for a in axes))

    def grads_of(self, idx: torch.Tensor, mask: torch.Tensor, gen=None):
        """(loss, grads {part: {name: tensor}}, (p_fake, forensic)) of the
        masked mean CE over a step's rows. With grad_accum = k the rows are
        k microbatches whose summed-CE gradients add up before one divide by
        the step's valid-row count (`trainer.py:926-1011`). Under
        debug_nans each backward runs under autograd's anomaly mode (it
        raises at the first backward function whose output holds a NaN) and
        the step's loss and outputs are checked for NaN with one sync; both
        raise FloatingPointError.

        On a mesh `idx` and `mask` are the global step's (every rank holds
        them): each microbatch's rows are cut to this rank's, the divide is
        by the global valid-row count, and the gradients come back summed
        over the data axes; the loss is this rank's share of the step's
        (the shares sum to it) and the outputs are this rank's rows."""
        params = self.state.params
        for mod in params.values():
            for p in mod.parameters():
                p.grad = None
        accum = max(1, int(self.cfg.grad_accum))
        debug = self.cfg.debug_nans
        denom = mask.sum().clamp_min(1.0)
        lsum = torch.zeros((), device=idx.device)
        p1s, fs = [], []
        mgen = self._mesh_gen(gen)
        for i, m in zip(idx.view(accum, -1), mask.view(accum, -1)):
            rows = self._split_rows(i)
            with span("train.forward"):
                ce, p1, f = self._forward(params, self._local(i), mgen, rows)
                ls = (ce * self._local(m)).sum()
            try:
                with span("train.backward"), \
                        torch.autograd.detect_anomaly(check_nan=True) if debug else nullcontext():
                    (ls / denom if accum == 1 else ls).backward()
            except RuntimeError as exc:
                if debug and "nan" in str(exc):
                    raise FloatingPointError(f"debug_nans: {exc}") from exc
                raise
            lsum = lsum + ls.detach()
            p1s.append(p1.detach())
            fs.append(f.detach())
        if debug:
            _raise_on_nan("train step's loss or outputs", lsum, *p1s, *fs)
        grads = {}
        for part, mod in self.trainable().items():
            grads[part] = {}
            for name, p in mod.named_parameters():
                grads[part][name] = p.grad if p.grad is not None else torch.zeros_like(p)
        if self.mesh is not None:
            self._reduce_grads(grads)
        if accum > 1:
            for d in grads.values():
                for g in d.values():
                    g.div_(denom)
        return lsum / denom, grads, (torch.cat(p1s), torch.cat(fs, dim=1))

    def train_step(self, idx: np.ndarray, mask: np.ndarray):
        """One optimizer step on corpus rows `idx`; (loss, p_fake, forensic)
        (on a mesh: this rank's share of the loss and its rows' outputs)."""
        with span("train.step"):
            with span("train.upload"):
                i = to_device(torch.as_tensor(idx), self.device, torch.int64)
                m = to_device(torch.as_tensor(mask), self.device, torch.float32)
            loss, grads, (p1, forensic) = self.grads_of(i, m, self.state.gen)
            with span("train.optimizer"):
                self.tx.apply(self.trainable(), self.state.opt_state, grads)
            self.state.step += 1
        return loss, p1, forensic

    @torch.inference_mode()
    def eval_step(self, params: Dict[str, nn.Module], idx: np.ndarray, mask: np.ndarray):
        """(loss, p_fake, forensic) of a batch (on a mesh: this rank's share
        of the loss and its rows' outputs, as `train_step`)."""
        i = to_device(torch.as_tensor(idx), self.device, torch.int64)
        m = to_device(torch.as_tensor(mask), self.device, torch.float32)
        ce, p1, forensic = self._forward(params, self._local(i), rows=self._split_rows(i))
        loss = (ce * self._local(m)).sum() / m.sum().clamp_min(1.0)
        if self.cfg.debug_nans:
            _raise_on_nan("eval step's loss or outputs", loss, p1, forensic)
        return loss, p1, forensic

    # ------------------------------------------------------------------
    def _batches(self, order: np.ndarray, is_train: bool):
        """[(chunk, mask, valid)] of `order`: batch_size * grad_accum rows
        per optimizer step in training, batch_size in eval."""
        eff = self.cfg.batch_size * (max(1, self.cfg.grad_accum) if is_train else 1)
        return list(iter_padded_batches(order, eff, shuffle=False))

    def epoch_order(self, split_idx: np.ndarray, is_train: bool) -> np.ndarray:
        """The epoch's row order: a train epoch shuffles with np.random's
        global stream (one draw per epoch, as the JAX trainer)."""
        if not is_train:
            return split_idx
        order = np.array(split_idx, dtype=np.int32)
        np.random.shuffle(order)
        return order

    def epoch_batches(self, split_idx: np.ndarray, is_train: bool):
        """The epoch's [(chunk, mask, valid)] (one shuffle for a train epoch)."""
        return self._batches(self.epoch_order(split_idx, is_train), is_train)

    def _save_step_checkpoint(self, epoch: int, cursor: int, order: np.ndarray) -> None:
        """The mid-epoch `latest` slot (save_every_steps; `trainer.py:1078-1104`):
        the JAX meta keys, with `in_epoch`, the step cursor, the epoch's
        batch order and np.random's state (the state file carries the
        parameters, AdamW state, step and dropout generator), plus the
        module dims every slot of the port carries."""
        meta = {
            "trainer": TRAINER_KIND,
            "epoch": int(epoch),
            "best_val_auc": self.best_val_auc,
            "no_improve": self.no_improve,
            "cfg": asdict(self.cfg),
            "in_epoch": True,
            "step_cursor": int(cursor),
            "epoch_order": np.asarray(order).tolist(),
            "np_random_state": np_random_state_payload(),
            "model": self.model_meta,
        }
        ckpt.save_checkpoint(self.cfg.out_dir, "latest", self.state, meta)

    def _assemble(self, losses: torch.Tensor, p1_mat: torch.Tensor, f_mat: torch.Tensor,
                  accum: int):
        """The global batches' (losses (S,), p_fake (S, B), forensic
        (S, 3, B)) from this rank's loss shares and rows: each rank fills
        its columns of zeros, one all-reduce over the data axes sums them."""
        d, parts = self._data.rank, self._data.size
        steps, n_local = p1_mat.shape
        per = n_local // accum  # this rank's rows of a microbatch
        pos = (torch.arange(accum)[:, None] * per * parts + d * per
               + torch.arange(per)[None]).reshape(-1).to(p1_mat.device)
        p1 = p1_mat.new_zeros(steps, n_local * parts)
        p1[:, pos] = p1_mat
        f = f_mat.new_zeros(steps, 3, n_local * parts)
        f[:, :, pos] = f_mat
        losses = losses.clone()
        coll.all_reduce_coalesced_([losses, p1, f], self._data)
        return losses, p1, f

    def _epoch_loop(self, split_idx: np.ndarray, split: str,
                    params: Optional[Dict[str, nn.Module]] = None,
                    epoch: Optional[int] = None) -> Tuple[float, Dict[str, float]]:
        """One pass over a split. A train pass inside fit() (`epoch` given)
        writes the mid-epoch slot every save_every_steps steps but after its
        last, and a resumed run's first train pass takes the saved order
        from the saved cursor (`trainer.py:1107-1190`)."""
        is_train = split == "train"
        params = params if params is not None else self.state.params
        save_k = int(self.cfg.save_every_steps) if is_train and epoch is not None else 0
        skip = 0
        if is_train and self._resume_order is not None:
            order, skip = self._resume_order, self._resume_cursor
            self._resume_order, self._resume_cursor = None, 0
            batches = self._batches(order, True)[skip:]
        else:
            order = self.epoch_order(split_idx, is_train)
            batches = self._batches(order, is_train)
        if not batches:
            return 0.0, aggregate_epoch_metrics(np.array([], int), np.array([], float))
        for mod in params.values():
            mod.train(is_train)
        outs = []
        for bi, (chunk, mask, _) in enumerate(batches):
            if is_train:
                outs.append(self.train_step(chunk, mask))
                if save_k > 0 and (bi + 1) % save_k == 0 and bi + 1 < len(batches):
                    self._save_step_checkpoint(epoch, skip + bi + 1, order)
            else:
                outs.append(self.eval_step(params, chunk, mask))
        losses = torch.stack([o[0].detach() for o in outs])
        p1_mat = torch.stack([o[1] for o in outs])
        f_mat = torch.stack([o[2] for o in outs])
        if self.mesh is not None:  # the global batches' outputs on every rank
            accum = max(1, int(self.cfg.grad_accum)) if is_train else 1
            losses, p1_mat, f_mat = self._assemble(losses, p1_mat, f_mat, accum)
        # one device -> host copy per epoch
        losses, p1_mat, f_mat = (t.cpu().numpy() for t in (losses, p1_mat, f_mat))
        y, p1, f_cat = flatten_epoch_rows(batches, self.cache["labels"], p1_mat, f_mat)
        metrics = aggregate_epoch_metrics(
            y, p1, forensic={"semantic_conflict": f_cat[0], "temporal_delay": f_cat[1],
                             "emotion_intensity": f_cat[2]})
        return float(np.mean(losses)), metrics

    def fit(self) -> float:
        cfg = self.cfg
        sel = {"acc": "accuracy"}.get(cfg.select_metric, cfg.select_metric)
        if sel not in ("auc", "accuracy", "f1", "precision", "recall"):
            raise ValueError(f"select_metric={cfg.select_metric!r} — use one of "
                             "auc/acc/f1/precision/recall")
        tracker = ImprovementTracker(cfg.out_dir, TRAINER_KIND, cfg.save_best,
                                     cfg.early_stop_patience, best=self.best_val_auc,
                                     no_improve=self.no_improve)
        with profiler_trace(cfg.profile_dir if ckpt.is_primary() else None, self.device):
            for epoch in range(self.start_epoch, cfg.epochs + 1):
                t0 = time.time()
                tr_loss, tr_metrics = self._epoch_loop(self.tr_idx, "train", epoch=epoch)
                va_loss, va_metrics = self._epoch_loop(self.va_idx, "val")
                dt = time.time() - t0
                print(f"[Epoch {epoch:02d}] train_loss={tr_loss:.4f} | ", end="")
                pretty_print("train", tr_metrics)
                print(f"           val_loss={va_loss:.4f} | ", end="")
                pretty_print("val", va_metrics)
                log_jsonl(cfg.out_dir, cfg.log_metrics_jsonl, {
                    "epoch": epoch, "seconds": dt, "train_loss": tr_loss, "val_loss": va_loss,
                    **{f"train_{k}": v for k, v in tr_metrics.items()},
                    **{f"val_{k}": v for k, v in va_metrics.items()},
                })
                # the resolved module dims travel with every slot (export_trained)
                extra = {"model": self.model_meta}
                tracker.update(float(va_metrics.get(sel, 0.5)), self.state, epoch,
                               asdict(cfg), extra)
                self.best_val_auc = tracker.best
                self.no_improve = tracker.no_improve
                meta = {**tracker.meta(epoch, asdict(cfg)), **extra,
                        "np_random_state": np_random_state_payload()}
                ckpt.save_checkpoint(cfg.out_dir, "latest", self.state, meta)
                if tracker.should_stop:
                    tracker.announce_stop()
                    break
        return self.best_val_auc

    def test(self) -> Dict[str, float]:
        """Test metrics of the `best` slot (of the live params when there is
        none, or it is foreign), with the JAX trainer's keys."""
        params = self.state.params
        restored = load_checkpoint_guarded(self.cfg.out_dir, "best", TRAINER_KIND,
                                           "testing current params", self.device)
        if restored is not None:
            best = copy.deepcopy(self.state.params)
            slot = TrainState(0, best, self.state.opt_state, self.state.gen, self._tp)
            try:
                payload = slot.local_payload(restored[0])
                slot.check_compatible(payload)
            except ValueError as exc:
                print(f"⚠️  best checkpoint does not fit this model ({exc}); "
                      "testing current params")
            else:
                for part, mod in best.items():
                    mod.load_state_dict(payload["params"][part])
                params = best
        ts_loss, m = self._epoch_loop(self.te_idx, "test", params=params)
        print(f"[Test] loss={ts_loss:.4f} | ", end="")
        pretty_print("test", m)
        return {
            "test_loss": ts_loss,
            "test_acc": m.get("accuracy", 0.0),
            "test_auc": m.get("auc", 0.5),
            "test_precision": m.get("precision", 0.0),
            "test_recall": m.get("recall", 0.0),
            "test_f1": m.get("f1", 0.0),
            "test_cmcs": m.get("cmcs", 0.0),
            "test_dfdr": m.get("dfdr", 0.0),
        }
