"""The integrated trainer (counterpart of `training/trainer_integrated.py`).

    trainer = IntegratedForensicTrainer(IntegratedTrainConfig(data_root=R, out_dir=O))
    results = trainer.train()     # epochs of train + val, then test()
    results = trainer.test()      # {test_loss, test_acc, test_auc} of `best`

The same feature cache as the v2 trainer (`data/cache.bootstrap_cache`),
with per-batch graphs in place of the transductive corpus graph:

* the full (N, N) pairwise OCR-Jaccard matrix (`ops/jaccard.pairwise_jaccard`)
  lives on the device; each step gathers its (B, B) sub-block, keeps the
  entries at or above the epoch's annealed threshold
  `max(0.05, gnn_overlap_thresh * 0.95 ** (epoch - 1))` as edge weights,
  zeroes the diagonal (the normalisation adds the self-loops) and masks
  a ragged last batch's padded rows out of the graph;
* the weighted sub-graph feeds `models/gnn.GNNModel` (ReLU, dropout 0.1)
  over the compact 416-wide node features (`ops/graphctx.compact_node_features`);
* class-weighted (`class_weighting`: w_c = 0.5 * total / count_c),
  label-smoothed (0.05) cross-entropy, normalised by the sum of the
  weights;
* AdamW after global-norm clipping (`grad_clip` 1.0) on a cosine decay to
  `lr * min_lr_scale` over `epochs * steps_per_epoch` steps (`use_cosine`),
  through `kernels/adamw.FusedAdamW`: one K1 launch per step on a GPU;
* early stop after 3 epochs without a better validation AUC, the `best`
  and `latest` slots with the meta's `"trainer": "integrated"`, and
  `resume`, which restarts from `latest` (the cosine schedule from the
  restored step, the threshold from the restored epoch) and adopts the
  slot's `hash_salt`.

The fusion and classifier are built from `fusion_config` /
`classifier_config` as the v2 trainer builds them (`trainer.module_configs`),
and each slot's meta records their dims under "model".
`bf16_compute` runs fusion and classifier in bf16 with f32 parameters,
AdamW state and checkpoints; `profile_dir` writes a torch.profiler trace
of `train()` (`<dir>/fit.trace.json`); `scan_epoch` is accepted and has no
effect (one step per Python call); `freeze_epochs` is the reference's
no-op, as in JAX. Dropout draws from the trainer's own `torch.Generator`.
A checkpoint of this trainer is not servable: `serving.Predictor` and the
exports refuse it, as the JAX Predictor does.
"""
from __future__ import annotations

import copy
import json
import math
import os
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.data.cache import bootstrap_cache
from ultrafnd_git_tpu_torch.kernels.adamw import FusedAdamW
from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer
from ultrafnd_git_tpu_torch.models.gnn import GNNModel
from ultrafnd_git_tpu_torch.models.initializers import jax_init_
from ultrafnd_git_tpu_torch.ops.graphctx import compact_node_features
from ultrafnd_git_tpu_torch.ops.hashing import set_hash_salt
from ultrafnd_git_tpu_torch.ops.jaccard import pairwise_jaccard
from ultrafnd_git_tpu_torch.training import checkpoint as ckpt
from ultrafnd_git_tpu_torch.training.loop import (
    ImprovementTracker,
    iter_padded_batches,
    load_checkpoint_guarded,
    log_jsonl,
    profiler_trace,
)
from ultrafnd_git_tpu_torch.training.metrics import safe_auc
from ultrafnd_git_tpu_torch.training.state import TrainState
from ultrafnd_git_tpu_torch.training.trainer import _adopt_model_dir_fields, module_configs
from ultrafnd_git_tpu_torch.utils.device import resolve_device, to_device

TRAINER_KIND = "integrated"
GNN_HID = 256
GNN_DROPOUT = 0.1


@dataclass
class IntegratedTrainConfig:
    """The JAX `IntegratedTrainConfig` (`trainer_integrated.py:70-109`):
    same field names and defaults, plus `model_dir`, a model directory
    whose feature cache the run may take (the v2 TrainConfig's)."""

    data_root: Optional[str] = None
    ocr_phrase_pkl: Optional[str] = None
    out_dir: str = "outputs_v2"
    epochs: int = 12
    batch_size: int = 16
    lr: float = 2e-4
    weight_decay: float = 1e-4
    seed: int = 42
    use_gnn: bool = True
    use_evidence: bool = False
    gnn_dim: int = 128
    gnn_overlap_thresh: float = 0.12
    save_best: bool = True
    resume: bool = False
    bf16_compute: bool = False
    label_smoothing: float = 0.05
    class_weighting: bool = False
    freeze_epochs: int = 0
    grad_clip: float = 1.0
    use_cosine: bool = True
    min_lr_scale: float = 0.1
    cache_to_disk: bool = True
    early_stop_patience: int = 3
    hash_salt: str = ""
    scan_epoch: bool = True
    log_metrics_jsonl: bool = True
    profile_dir: Optional[str] = None
    fusion_config: str = "configs/model_configs/fusion.yaml"
    classifier_config: str = "configs/model_configs/classifier.yaml"
    model_dir: Optional[str] = None


def cosine_schedule(lr: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(lr, decay_steps, alpha) in the f32
    arithmetic of a jitted JAX step on the CPU: XLA folds pi / decay_steps
    and 0.5 * (1 - alpha) into f32 constants and contracts the multiply-add
    into one rounding, so lr * ((cos(min(count, decay) * k) + 1) * c +
    alpha). The cosine is the correctly rounded one; XLA's f32 cosine is
    within one ulp of it, so a rare step's rate is one f32 ulp away."""
    f32 = np.float32
    k = f32(np.pi) / f32(decay_steps)
    c = f32(f32(0.5) * f32(1.0 - alpha))
    a, r = f32(alpha), f32(lr)

    def schedule(count: int) -> float:
        x = f32(min(f32(count), f32(decay_steps)) * k)
        cos1 = f32(f32(np.cos(np.float64(x))) + f32(1.0))
        mix = f32(np.float64(cos1) * np.float64(c) + np.float64(a))  # exact product, one rounding
        return float(f32(mix * r))

    return schedule


def annealed_thresh(thr0: float, epoch_zero_based: int) -> float:
    """The epoch's edge threshold, max(0.05, thr0 * 0.95 ** epoch)."""
    return max(0.05, thr0 * (0.95 ** epoch_zero_based))


class IntegratedForensicTrainer:
    """Mini-batch-graph trainer with the annealed OCR-Jaccard adjacency.

    `device` is "cuda" by default and raises without a GPU; pass "cpu" to
    run the plain versions of the kernels on the CPU.
    """

    def __init__(self, cfg: IntegratedTrainConfig, cache: Optional[Dict[str, Any]] = None,
                 device: str = "cuda"):
        self.cfg = cfg
        os.makedirs(cfg.out_dir, exist_ok=True)
        self.device = dev = resolve_device(device)
        np.random.seed(cfg.seed)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        if cfg.resume:
            # the salt is the featurization draw: resuming under another
            # would train the restored weights on features they never saw
            saved: Dict[str, Any] = {}
            try:
                with open(os.path.join(cfg.out_dir, "latest", "meta.json"), encoding="utf-8") as fh:
                    saved = json.load(fh).get("cfg", {})
            except (OSError, ValueError):
                pass
            if saved and saved.get("hash_salt", "") != cfg.hash_salt:
                print(f"note: checkpoint was trained with hash_salt="
                      f"{saved.get('hash_salt', '')!r}; adopting it")
                cfg.hash_salt = str(saved.get("hash_salt", ""))
        set_hash_salt(cfg.hash_salt)  # before any featurization

        # ---- cache (the v2 trainer's ladder) ------------------------------
        self.cache, self.cache_source = bootstrap_cache(
            cfg.out_dir, cfg.model_dir, cache, cfg.cache_to_disk,
            reuse_stale_features=bool(cfg.resume), data_root=cfg.data_root,
            ocr_phrase_pkl=cfg.ocr_phrase_pkl, seed=cfg.seed, device=str(dev))
        if self.cache_source == "model_dir":
            _adopt_model_dir_fields(cfg)
            set_hash_salt(cfg.hash_salt)
        self.train_idx, self.val_idx, self.test_idx = (np.asarray(s) for s in self.cache["split"])
        labels = np.asarray(self.cache["labels"])

        def dist(idx):
            y = labels[idx]
            return {int(c): int((y == c).sum()) for c in np.unique(y)}

        print(f"[Split] sizes train/val/test = {len(self.train_idx)}/"
              f"{len(self.val_idx)}/{len(self.test_idx)}")
        print(f"[Split] label dist train: {dist(self.train_idx)} | "
              f"val: {dist(self.val_idx)} | test: {dist(self.test_idx)}")

        # ---- device-resident corpus and pairwise Jaccard -------------------
        def put(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x)).to(dev, dtype)

        self.corpus: Dict[str, torch.Tensor] = {
            "text": put(self.cache["text"]),
            "audio": put(self.cache["audio"]),
            "visual": put(self.cache["visual"]),
            "temporal": put(self.cache["temporal"]),
            "aux": put(self.cache["aux"]),
            "labels": put(labels, torch.int64),
        }
        if cfg.use_evidence and "evidence" in self.cache:
            self.corpus["evidence"] = put(self.cache["evidence"])
        if cfg.use_gnn:
            self.corpus["xg"] = put(compact_node_features(self.cache))
            self.corpus["jac"] = put(pairwise_jaccard(self.cache["ocr_sets"]))

        # ---- class weights --------------------------------------------------
        if cfg.class_weighting:
            pos, neg = float((labels == 1).sum()), float((labels == 0).sum())
            total = max(1.0, pos + neg)
            w = [0.5 * total / max(1.0, neg), 0.5 * total / max(1.0, pos)]
        else:
            w = [1.0, 1.0]
        self.class_w = torch.tensor(w, dtype=torch.float32, device=dev)

        # ---- modules (the JAX package's initial distributions) -------------
        widths = {k: int(self.cache[k].shape[1]) for k in ("text", "audio", "visual", "temporal")}
        dtype = torch.bfloat16 if cfg.bf16_compute else None  # f32 masters either way
        fusion_kw, clf_kw = module_configs(cfg, widths["text"], widths)
        # the fusion and classifier dims, in every slot's meta as the v2 trainer's
        self.model_meta = {
            "fusion": {k: v for k, v in fusion_kw.items() if k != "dropout"},
            "classifier": {k: v for k, v in clf_kw.items() if k not in ("dropout", "node_dropout")},
        }
        params: Dict[str, nn.Module] = {
            "fusion": CrossModalTransformer(**fusion_kw, dtype=dtype),
            "clf": DeepTruthClassifier(in_dim=fusion_kw["hidden"], **clf_kw, dtype=dtype),
        }
        if cfg.use_gnn:
            params["gnn"] = GNNModel(int(self.corpus["xg"].shape[1]), GNN_HID, cfg.gnn_dim,
                                     GNN_DROPOUT)
        init_gen = torch.Generator().manual_seed(cfg.seed)  # same draws on any device
        for part, mod in params.items():
            jax_init_(part, mod, init_gen).to(dev)

        # ---- AdamW + clip + cosine ------------------------------------------
        steps_per_epoch = max(1, math.ceil(len(self.train_idx) / cfg.batch_size))
        self.decay_steps = max(1, cfg.epochs * steps_per_epoch)
        schedule = (cosine_schedule(cfg.lr, self.decay_steps, cfg.min_lr_scale)
                    if cfg.use_cosine else (lambda count: float(np.float32(cfg.lr))))
        self.tx = FusedAdamW(schedule, weight_decay=cfg.weight_decay,
                             grad_clip=cfg.grad_clip or 0.0)
        self.state = TrainState(step=0, params=params, opt_state=self.tx.init(params), gen=gen)

        self.start_epoch = 1
        self.best_score = -1.0
        self.no_improve = 0
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
                    # the cosine schedule continues from the restored step,
                    # the annealed threshold from the restored epoch
                    self.start_epoch = int(meta.get("epoch", 0)) + 1
                    self.best_score = float(meta.get("best_val_auc", -1.0))
                    self.no_improve = int(meta.get("no_improve", 0))
        self._frozen = cfg.freeze_epochs > 0  # the reference's no-op

    # ------------------------------------------------------------------
    def loss_from_logits(self, logits: torch.Tensor, y: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
        """Class-weighted, label-smoothed cross-entropy over the masked rows,
        normalised by the sum of the weights (torch CrossEntropyLoss(weight=)
        semantics, as the JAX trainer)."""
        c = logits.shape[-1]
        eps = self.cfg.label_smoothing
        soft = F.one_hot(y, c).float() * (1.0 - eps) + eps / c
        logp = F.log_softmax(logits.float(), dim=-1)
        w = self.class_w[y] * mask
        per = -(soft * logp).sum(dim=-1)
        return (per * w).sum() / w.sum().clamp_min(1e-9)

    def batch_graph(self, idx: torch.Tensor, mask: torch.Tensor, thr: float) -> torch.Tensor:
        """The (B, B) weighted sub-graph of rows `idx`: Jaccard entries at or
        above `thr`, diagonal 0 (the normalisation adds the self-loops), and
        the padded rows of a ragged batch masked out of it (a padded
        duplicate would add a Jaccard-1 edge to its original)."""
        jb = self.corpus["jac"][idx][:, idx]
        eye = torch.eye(idx.shape[0], dtype=torch.bool, device=idx.device)
        adj = torch.where((jb >= thr) & ~eye, jb, torch.zeros_like(jb))
        return adj * mask[:, None] * mask[None, :]

    def _forward(self, params: Dict[str, nn.Module], idx: torch.Tensor, mask: torch.Tensor,
                 thr: float, gen: Optional[torch.Generator] = None):
        """(logits, probs) of corpus rows `idx`; `gen` = None is eval mode,
        a generator turns dropout on."""
        c = self.corpus
        feats = {
            "text_features": c["text"][idx],
            "audio_features": c["audio"][idx],
            "visual_features": c["visual"][idx],
            "temporal_features": c["temporal"][idx],
        }
        if "evidence" in c:
            feats["evidence"] = c["evidence"][idx]
        if self.cfg.use_gnn:
            feats["gnn_feat"] = params["gnn"](c["xg"][idx], self.batch_graph(idx, mask, thr), gen)
        fo = params["fusion"](feats, gen)
        co = params["clf"](fo["fused"], c["aux"][idx], gen)
        return co["logits"], co["probs"]

    def grads_of(self, idx: torch.Tensor, mask: torch.Tensor, thr: float,
                 gen: Optional[torch.Generator] = None):
        """(loss, grads {part: {name: tensor}}, p_fake) of one batch."""
        params = self.state.params
        for mod in params.values():
            for p in mod.parameters():
                p.grad = None
        logits, probs = self._forward(params, idx, mask, thr, gen)
        loss = self.loss_from_logits(logits, self.corpus["labels"][idx], mask)
        loss.backward()
        grads = {part: {name: p.grad if p.grad is not None else torch.zeros_like(p)
                        for name, p in mod.named_parameters()}
                 for part, mod in params.items()}
        return loss.detach(), grads, probs[:, 1].detach()

    def train_step(self, idx: np.ndarray, mask: np.ndarray, thr: float):
        """One optimizer step (one K1 launch on a GPU); (loss, p_fake)."""
        i = to_device(torch.as_tensor(idx), self.device, torch.int64)
        m = to_device(torch.as_tensor(mask), self.device, torch.float32)
        loss, grads, p1 = self.grads_of(i, m, thr, self.state.gen)
        self.tx.apply(self.state.params, self.state.opt_state, grads)
        self.state.step += 1
        return loss, p1

    @torch.inference_mode()
    def eval_step(self, params: Dict[str, nn.Module], idx: np.ndarray, mask: np.ndarray,
                  thr: float):
        i = to_device(torch.as_tensor(idx), self.device, torch.int64)
        m = to_device(torch.as_tensor(mask), self.device, torch.float32)
        logits, probs = self._forward(params, i, m, thr)
        return self.loss_from_logits(logits, self.corpus["labels"][i], m), probs[:, 1]

    # ------------------------------------------------------------------
    def annealed_thresh(self, epoch_zero_based: int) -> float:
        return annealed_thresh(self.cfg.gnn_overlap_thresh, epoch_zero_based)

    def run_split(self, idx: np.ndarray, thr: float, train: bool,
                  params: Optional[Dict[str, nn.Module]] = None) -> Tuple[float, float, float]:
        """(mean loss, accuracy, AUC) of one pass over a split; a train pass
        shuffles with np.random's global stream and steps the optimizer."""
        params = params if params is not None else self.state.params
        batches = list(iter_padded_batches(idx, self.cfg.batch_size, shuffle=train))
        if not batches:
            return 0.0, 0.0, 0.5
        for mod in params.values():
            mod.train(train)
        outs = [self.train_step(c, m, thr) if train else self.eval_step(params, c, m, thr)
                for c, m, _ in batches]
        # one device -> host copy per pass
        losses = torch.stack([o[0] for o in outs]).cpu().numpy()
        p1_mat = torch.stack([o[1] for o in outs]).cpu().numpy()
        labels = self.cache["labels"]
        y = np.concatenate([labels[c[:v]] for c, _, v in batches])
        p1 = np.concatenate([p1_mat[i, :v] for i, (_, _, v) in enumerate(batches)])
        acc = float(((p1 >= 0.5).astype(int) == y).mean()) if y.size else 0.0
        return float(np.mean(losses)), acc, safe_auc(y, p1)

    def train(self) -> Dict[str, float]:
        print("\n>>> Training (integrated variant)...")
        with profiler_trace(self.cfg.profile_dir, self.device):
            return self._train_loop()

    def _train_loop(self) -> Dict[str, float]:
        cfg = self.cfg
        tracker = ImprovementTracker(cfg.out_dir, TRAINER_KIND, cfg.save_best,
                                     cfg.early_stop_patience, best=self.best_score,
                                     no_improve=self.no_improve)
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            thr = self.annealed_thresh(epoch - 1)
            if self._frozen and epoch > cfg.freeze_epochs:
                print("→ Unfreezing encoders")  # the reference's no-op
                self._frozen = False
            tr_loss, tr_acc, tr_auc = self.run_split(self.train_idx, thr, train=True)
            val_loss, val_acc, val_auc = self.run_split(self.val_idx, thr, train=False)
            print(f"[Epoch {epoch:02d}] train: loss={tr_loss:.4f} acc={tr_acc:.3f} "
                  f"auc={tr_auc:.3f} | val: loss={val_loss:.4f} acc={val_acc:.3f} "
                  f"auc={val_auc:.3f} | thr={thr:.3f}")
            log_jsonl(cfg.out_dir, cfg.log_metrics_jsonl, {
                "epoch": epoch, "thr": thr, "train_loss": tr_loss, "train_acc": tr_acc,
                "train_auc": tr_auc, "val_loss": val_loss, "val_acc": val_acc,
                "val_auc": val_auc,
            })
            extra = {"model": self.model_meta}
            tracker.update(val_auc, self.state, epoch, asdict(cfg), extra)
            self.best_score = tracker.best
            self.no_improve = tracker.no_improve
            # `latest` every epoch: restart-from-latest fault recovery
            ckpt.save_checkpoint(cfg.out_dir, "latest", self.state,
                                 {**tracker.meta(epoch, asdict(cfg)), **extra})
            if tracker.should_stop:
                tracker.announce_stop()
                break
        return self.test()

    def test(self) -> Dict[str, float]:
        """Test metrics of the `best` slot (of the live params when there is
        none, or it is foreign), at the threshold of the slot's epoch."""
        print("\n>>> Testing best checkpoint...")
        params = self.state.params
        epoch = self.cfg.epochs
        restored = load_checkpoint_guarded(self.cfg.out_dir, "best", TRAINER_KIND,
                                           "testing current params", self.device)
        if restored is not None:
            best = copy.deepcopy(self.state.params)
            try:
                TrainState(0, best, self.state.opt_state, self.state.gen).check_compatible(
                    restored[0])
            except ValueError as exc:
                print(f"⚠️  best checkpoint does not fit this model ({exc}); "
                      "testing current params")
            else:
                for part, mod in best.items():
                    mod.load_state_dict(restored[0]["params"][part])
                params = best
                epoch = int(restored[1].get("epoch", epoch))
        thr = self.annealed_thresh(max(0, epoch - 1))
        loss, acc, auc = self.run_split(self.test_idx, thr, train=False, params=params)
        print(f"[Test] loss={loss:.4f} acc={acc:.3f} auc={auc:.3f}\n")
        return {"test_loss": loss, "test_acc": acc, "test_auc": auc}
