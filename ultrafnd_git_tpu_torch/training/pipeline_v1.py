"""The v1 raw-media ensemble pipeline: decode -> featurize -> ensemble
train and evaluate (counterpart of `training/pipeline_v1.py`).

    python -m ultrafnd_git_tpu_torch.training.pipeline_v1 --data_dir ROOT [--cpu]

* `data/media.py` decodes each record (frames, waveform, comments) and
  `multimodal_collate` batches them; training batches go through
  `AugmentedRawMediaDataset`; a run without a data root (or `--debug`)
  trains on seeded random features instead, as JAX's does.
* `BatchFeatureExtractor` turns a collated batch into the trainer's
  columns: text (the text ladder, `models/encoders.TextFieldEncoder`),
  audio (`SpectralForensics` on the waveform: the wav2vec2 twin on the
  extractor's device when local weights load, else spectral statistics;
  the evidence scorers' HF twins likewise), visual (flow features ++
  ELA / LBP of the middle frame, L2-normed), temporal (the align MLP on
  the extractor's device), aux [delay, emotion intensity] and evidence
  [semantic gap, emotion intensity, tamper]. Flow and the chronos cues
  come from the device CV stage (`kernels/preprocess.DeviceCVStage`) when
  the extractor's device is CUDA, else from the host cv2 ladder;
  `ULTRAFND_DEVICE_CV=0` picks the host ladder and `=1` the stage (on the
  CPU with `--cpu`). `stream` enqueues batch N + 1's stage before batch
  N's host work, so its upload and flow ride under that work.
* `EnsembleTrainer`: E members of CrossModalTransformer(use_gnn=False) ->
  DeepTruthClassifier (`fusion_config` / `classifier_config`), each with
  JAX's initial distributions from one torch.Generator(seed); mixup (the
  same numpy draws as JAX's), focal loss (CE as logsumexp - logit);
  a Python loop over the members where JAX vmaps them. Each member's
  gradient is scaled by min(1, clip / (its global norm + 1e-9)) on the
  device, then every member's leaves go through ONE K1 launch a step
  (`kernels/adamw.FusedAdamW` with no clip of its own: optax.adamw's
  update). Dropout draws from a torch.Generator seeded with seed + 1.
  Prediction is the mean of the members' logits.

No CPU fallback: JAX's v1 moves its state to the CPU when a step fails
on the accelerator, and drops to the host cv2 ladder when the device CV
stage fails; here a failing step or stage raises.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ultrafnd_git_tpu_torch.data.media import (
    AugmentedRawMediaDataset,
    RawMediaDataset,
    multimodal_collate,
)
from ultrafnd_git_tpu_torch.kernels.adamw import FusedAdamW, global_norm
from ultrafnd_git_tpu_torch.models.audio import SpectralForensics
from ultrafnd_git_tpu_torch.models.chronos import ChronosGuard, cut_scores
from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer
from ultrafnd_git_tpu_torch.models.initializers import jax_init_
from ultrafnd_git_tpu_torch.models.visual import (
    DeepForgeryDetector,
    OpticalFlow3DCNN,
    ensure_gray,
    frames_from_input,
    resize,
)
from ultrafnd_git_tpu_torch.training.metrics import safe_auc
from ultrafnd_git_tpu_torch.utils.config import classifier_config, fusion_config
from ultrafnd_git_tpu_torch.utils.device import (
    add_device_args,
    resolve_cpu_flag,
    resolve_device,
    to_device,
)

FEATURE_DIMS = {"text": 768, "audio": 128, "visual": 512, "temporal": 256}
DEVICE_CV = "ULTRAFND_DEVICE_CV"


@dataclass
class V1Config:
    data_dir: Optional[str] = None
    epochs: int = 5
    batch_size: int = 4
    lr: float = 1e-4
    weight_decay: float = 1e-4
    ensemble_size: int = 2
    mixup_alpha: float = 0.2
    use_focal: bool = True
    focal_alpha: float = 1.0
    focal_gamma: float = 2.0
    augment: bool = True
    grad_clip: float = 1.0
    early_stop_patience: int = 15
    eval_every: int = 5  # evaluate every 5 epochs, and after the last
    seed: int = 42
    debug_mode: bool = False  # tiny dummy run
    dummy_samples: int = 32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample CE as optax computes it: logsumexp - the label's logit."""
    return torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[:, None])[:, 0]


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    alpha: float = 1.0,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Per-sample focal loss: alpha * (1 - pt)^gamma * CE."""
    ce = cross_entropy(logits, labels)
    pt = torch.exp(-ce)
    return alpha * (1.0 - pt) ** gamma * ce


def mixup_arrays(
    rng: np.random.Generator, batch_size: int, alpha: float
) -> Tuple[float, np.ndarray]:
    """Host mixup draw (lam, permutation): JAX's draws, in its order."""
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    return lam, rng.permutation(batch_size).astype(np.int32)


# ----------------------------------------------------------------------
# Host feature extraction (the "7 encoders" stage)
# ----------------------------------------------------------------------

def device_cv_wanted(device: torch.device) -> bool:
    """The device CV stage's switch: `ULTRAFND_DEVICE_CV` when set ("1" on,
    anything else off), else on exactly when `device` is CUDA."""
    env = os.environ.get(DEVICE_CV)
    if env is not None:
        return env == "1"
    return device.type == "cuda"


class BatchFeatureExtractor:
    """Raw collated batch -> fixed-width feature dict + evidence scalars."""

    def __init__(self, seed: int = 42, use_device_cv: Optional[bool] = None,
                 device: str = "cuda"):
        from ultrafnd_git_tpu_torch.data.cache import make_encoders

        self.device = resolve_device(device)
        enc = make_encoders(seed=seed, device=str(self.device))
        self.text_enc = enc["text"]
        # the cache's audio / flow / ELA entries are text proxies: v1 takes
        # the encoders that read waveforms and frames, at the same widths
        self.audio_enc = SpectralForensics(dim=128, device=str(self.device))
        self.flow = OpticalFlow3DCNN(dim=256)
        # cv2 algorithm objects are stateful: each pool thread gets its own
        self._tls = threading.local()
        self.ela = DeepForgeryDetector(dim=256)
        self.tsync = enc["tsync"]
        self.affective = enc["affective"]
        self.chronos = ChronosGuard.from_config()
        self.semantic = enc["semantic"]
        if use_device_cv is None:
            use_device_cv = device_cv_wanted(self.device)
        self._device_cv = None
        if use_device_cv:
            from ultrafnd_git_tpu_torch.kernels.preprocess import DeviceCVStage

            self._device_cv = DeviceCVStage(flow_dim=self.flow.dim, device=str(self.device))

    @staticmethod
    def _gray_host(arr: np.ndarray) -> np.ndarray:
        """uint8 RGB clips -> uint8 gray clips by cv2 (a third of the bytes
        to upload); the clips as they are without cv2 or for float input
        (the stage then takes gray on the device)."""
        try:
            import cv2
        except Exception:
            return arr
        if arr.dtype != np.uint8:
            return arr
        b, t, h, w, _ = arr.shape
        # cvtColor is per pixel: every frame as one tall image, one call
        gray = cv2.cvtColor(
            np.ascontiguousarray(arr).reshape(b * t * h, w, 3), cv2.COLOR_RGB2GRAY
        )
        return gray.reshape(b, t, h, w)

    def _cv_pool(self):
        """One long-lived pool, so the thread-local flow solvers are reused."""
        if getattr(self, "_pool", None) is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=8)
        return self._pool

    def close(self) -> None:
        """Stop the host ladder's thread pool (a no-op when none started)."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
            self._pool = None

    def _cv_dispatch(self, batch: Dict[str, Any]):
        """Start the device CV stage on `batch` (gray on the host, upload and
        stage enqueued); None when the host ladder takes this batch."""
        if self._device_cv is None:
            return None
        arr = np.asarray(batch["video_frames"])
        if arr.ndim != 5 or arr.shape[1] < 2 or arr.shape[-1] != 3:
            return None
        return self._device_cv.dispatch(self._gray_host(arr))

    def _device_cv_block(self, frames, pending) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """ELA on the host (the middle frames' JPEG pass, while the device
        works), then the stage's cues."""
        ela_feats = np.stack([self.ela.ela_lbp(clip) for clip in np.asarray(frames)])
        out = self._device_cv.finalize(pending)
        return out["flow_feat"], ela_feats, out["tamper"]

    def stream(self, batches_with_meta):
        """Featurize (batch, meta) pairs with cross-batch double buffering:
        batch N + 1's device CV stage is enqueued before batch N's host
        work. Yields (features, batch, meta) in order."""
        prev = None
        for batch, meta in batches_with_meta:
            cur = (batch, meta, self._cv_dispatch(batch))
            if prev is not None:
                pb, pm, pp = prev
                yield self._extract(pb, pp), pb, pm
            prev = cur
        if prev is not None:
            pb, pm, pp = prev
            yield self._extract(pb, pp), pb, pm

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return self._extract(batch, self._cv_dispatch(batch))

    def _thread_flow(self) -> OpticalFlow3DCNN:
        inst = getattr(self._tls, "flow", None)
        if inst is None:
            inst = self._tls.flow = OpticalFlow3DCNN(dim=self.flow.dim)
        return inst

    def _cv_worker(self, clip):
        """The host ladder on one clip: (flow feature, ELA feature, tamper),
        the dense flow computed once for both the flow pool and the cues."""
        flow_enc = self._thread_flow()
        fr = frames_from_input(clip)
        if not fr or len(fr) < 2:
            return np.zeros(flow_enc.dim, np.float32), self.ela.ela_lbp(clip), 0.0
        gray = np.stack([ensure_gray(resize(f, (256, 256))) for f in fr])
        flows = flow_enc.flows_for_gray(gray)
        tamper = self.chronos.tamper_score_from_cues(
            cut_scores(gray), self.chronos.flow_mags_from_flows(flows))
        return flow_enc.pool_flows(flows), self.ela.ela_lbp(clip), tamper

    def _extract(self, batch: Dict[str, Any], cv_pending=None) -> Dict[str, np.ndarray]:
        from ultrafnd_git_tpu_torch.data.cache import alignment_delay

        records = [
            {
                "title": t.get("title", ""),
                "ocr": t.get("ocr", "") or t.get("description", ""),
                "comments": t.get("comments", []),
            }
            for t in batch["text_data"]
        ]
        T = self.text_enc.encode_fields_batch(records)  # (B, 768)
        A = self.audio_enc.extract_waveform_batch(batch["audio_waveform"])  # (B, 128)

        frames = batch["video_frames"]  # (B, 30, 256, 256, 3)
        if cv_pending is None:
            cv_pending = self._cv_dispatch(batch)
        if cv_pending is not None:
            flow_feats, ela_feats, tamper_list = self._device_cv_block(frames, cv_pending)
        else:
            flow_feats, ela_feats, tamper_list = zip(*self._cv_pool().map(self._cv_worker,
                                                                          frames))
        V = np.concatenate([np.stack(flow_feats), np.stack(ela_feats)], axis=1).astype(
            np.float32)  # (B, 512)
        V /= np.linalg.norm(V, axis=1, keepdims=True) + 1e-9
        tamper = np.asarray(tamper_list, dtype=np.float32)

        U, U_tt = self.tsync.align_batch_pair(T, V)  # (B, 256) each, one device pass
        delay = alignment_delay(U_tt, U)

        full_text = [(r["title"] + " " + r["ocr"]).strip() for r in records]
        aff = self.affective.analyze_batch(full_text, list(batch["audio_waveform"]))
        sem_gap = self.semantic.gap_magnitude([r["title"] for r in records],
                                              [r["ocr"] for r in records])
        evidence = np.stack([sem_gap, aff["intensity"], tamper], axis=1)
        aux = np.stack([delay, aff["intensity"]], axis=1).astype(np.float32)
        return {
            "text": T.astype(np.float32),
            "audio": A.astype(np.float32),
            "visual": V,
            "temporal": U.astype(np.float32),
            "aux": aux,
            "evidence": evidence.astype(np.float32),
        }


# ----------------------------------------------------------------------
# Ensemble trainer
# ----------------------------------------------------------------------

Member = Dict[str, nn.Module]  # {"fusion": CrossModalTransformer, "clf": DeepTruthClassifier}


class EnsembleTrainer:
    """E (fusion -> classifier) members, stepped together through one K1
    launch. `device` is "cuda" by default and raises without a GPU."""

    def __init__(self, cfg: V1Config, device: str = "cuda"):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        fusion = fusion_config()
        clf_kw = classifier_config()
        init_gen = torch.Generator().manual_seed(cfg.seed)  # same draws on any device
        self.members: List[Member] = []
        for _ in range(cfg.ensemble_size):
            member = {
                "fusion": CrossModalTransformer(
                    hidden=fusion["hidden"], dropout=fusion["dropout"], use_gnn=False,
                    **{f"{k}_dim": d for k, d in FEATURE_DIMS.items()}),
                "clf": DeepTruthClassifier(in_dim=fusion["hidden"], **clf_kw),
            }
            for part, mod in member.items():
                jax_init_(part, mod, init_gen).to(dev)
            self.members.append(member)
        # optax.adamw(lr, wd): the per-member clip is applied before it
        self.tx = FusedAdamW(lambda count: float(np.float32(cfg.lr)),
                             weight_decay=cfg.weight_decay, grad_clip=0.0)
        self.opt_state = self.tx.init(self.params)
        # scaled gradients land in these buffers, so K1's leaf table stays put
        self._grad_bufs = {part: {n: torch.zeros_like(p) for n, p in mod.named_parameters()}
                           for part, mod in self.params.items()}
        self.gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        self.step_count = 0

    @property
    def params(self) -> Dict[str, nn.Module]:
        """Every member's modules under one dict, {"fusion0", "clf0", ...}:
        the tree K1 steps in one launch."""
        return {f"{part}{e}": mod for e, m in enumerate(self.members)
                for part, mod in m.items()}

    def load_state_dicts(self, pairs: Sequence[Tuple[Dict[str, Any], Dict[str, Any]]]) -> None:
        """Each member's (fusion, classifier) state dicts, as
        `utils/transfer.ensemble_state_dicts_from_params` gives them."""
        if len(pairs) != len(self.members):
            raise ValueError(f"{len(pairs)} members given for an ensemble of "
                             f"{len(self.members)}")
        for m, (fsd, csd) in zip(self.members, pairs):
            for part, sd in (("fusion", fsd), ("clf", csd)):
                m[part].load_state_dict({k: torch.as_tensor(np.asarray(v))
                                         for k, v in sd.items()})

    def _place(self, feats: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: to_device(torch.as_tensor(np.asarray(v, np.float32)), self.device)
                for k, v in feats.items()}

    @staticmethod
    def member_logits(member: Member, feats: Dict[str, torch.Tensor],
                      gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 2) logits of one member; `gen` = None is eval mode."""
        fo = member["fusion"]({
            "text_features": feats["text"],
            "audio_features": feats["audio"],
            "visual_features": feats["visual"],
            "temporal_features": feats["temporal"],
            "evidence": feats["evidence"],
        }, gen)
        return member["clf"](fo["fused"], feats["aux"], gen)["logits"]

    def member_loss(self, member: Member, feats: Dict[str, torch.Tensor], y: torch.Tensor,
                    lam: torch.Tensor, perm: torch.Tensor,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """The mixed batch's mean loss: lam * loss(y) + (1 - lam) * loss(y[perm])."""
        cfg = self.cfg
        mixed = {k: lam * v + (1.0 - lam) * v[perm] for k, v in feats.items()}
        logits = self.member_logits(member, mixed, gen)
        if cfg.use_focal:
            la = focal_loss(logits, y, cfg.focal_alpha, cfg.focal_gamma)
            lb = focal_loss(logits, y[perm], cfg.focal_alpha, cfg.focal_gamma)
        else:
            la = cross_entropy(logits, y)
            lb = cross_entropy(logits, y[perm])
        return (lam * la + (1.0 - lam) * lb).mean()

    def grads_of(self, feats: Dict[str, np.ndarray], labels: np.ndarray, lam: float,
                 perm: np.ndarray, gen: Optional[torch.Generator] = None):
        """(losses (E,), [{part: {name: grad}}] per member) of one batch;
        `gen` = None turns dropout off."""
        dev = self.device
        x = self._place(feats)
        y = to_device(torch.as_tensor(np.asarray(labels, np.int64)), dev)
        p = to_device(torch.as_tensor(np.asarray(perm, np.int64)), dev)
        lam_t = to_device(torch.tensor(lam, dtype=torch.float32), dev)
        losses, grads = [], []
        for member in self.members:
            loss = self.member_loss(member, x, y, lam_t, p, gen)
            names = [(part, n, q) for part, mod in member.items()
                     for n, q in mod.named_parameters()]
            # the fusion's own logits head takes no part: its gradient is 0
            gs = torch.autograd.grad(loss, [q for _, _, q in names], allow_unused=True)
            g: Dict[str, Dict[str, torch.Tensor]] = {part: {} for part in member}
            for (part, n, q), gi in zip(names, gs):
                g[part][n] = torch.zeros_like(q) if gi is None else gi
            losses.append(loss.detach())
            grads.append(g)
        return torch.stack(losses), grads

    @torch.no_grad()
    def apply_grads(self, grads: Sequence[Dict[str, Dict[str, torch.Tensor]]]) -> None:
        """Scale each member's gradient by min(1, clip / (norm + 1e-9)) on
        the device, then step every member through one K1 launch."""
        clip = self.cfg.grad_clip
        scaled: Dict[str, Dict[str, torch.Tensor]] = {}
        for e, g in enumerate(grads):
            leaves = [g[part][n] for part, mod in self.members[e].items()
                      for n, _ in mod.named_parameters()]
            scale = None
            if clip and clip > 0:
                norm = global_norm(leaves)
                scale = torch.minimum(torch.ones_like(norm),
                                      torch.full_like(norm, clip) / (norm + 1e-9))
            for part, d in g.items():
                bufs = self._grad_bufs[f"{part}{e}"]
                for n, buf in bufs.items():
                    if scale is None:
                        buf.copy_(d[n])
                    else:
                        torch.mul(d[n], scale, out=buf)
                scaled[f"{part}{e}"] = bufs
        self.tx.apply(self.params, self.opt_state, scaled)
        self.step_count += 1

    def train_batch(self, feats: Dict[str, np.ndarray], labels: np.ndarray,
                    host_rng: np.random.Generator) -> float:
        """One step on a batch (mixup drawn from `host_rng`); the members'
        mean loss."""
        lam, perm = mixup_arrays(host_rng, labels.shape[0], self.cfg.mixup_alpha)
        losses, grads = self.grads_of(feats, labels, lam, perm, self.gen)
        self.apply_grads(grads)
        return float(losses.mean())

    @torch.inference_mode()
    def predict_batch(self, feats: Dict[str, np.ndarray]) -> np.ndarray:
        """(B, 2) softmax of the members' mean logits."""
        x = self._place(feats)
        logits = torch.stack([self.member_logits(m, x) for m in self.members]).mean(dim=0)
        return torch.softmax(logits, dim=-1).cpu().numpy()


# ----------------------------------------------------------------------
# Dummy data (no media)
# ----------------------------------------------------------------------

def _dummy_feature_batches(
    n: int, batch_size: int, seed: int
) -> List[Tuple[Dict[str, np.ndarray], np.ndarray]]:
    rng = np.random.default_rng(seed)
    batches = []
    for s in range(0, n, batch_size):
        b = min(batch_size, n - s)
        if b < batch_size:
            break  # fixed shapes only
        feats = {
            "text": rng.standard_normal((b, 768)).astype(np.float32),
            "audio": rng.standard_normal((b, 128)).astype(np.float32),
            "visual": rng.standard_normal((b, 512)).astype(np.float32),
            "temporal": rng.standard_normal((b, 256)).astype(np.float32),
            "aux": rng.uniform(size=(b, 2)).astype(np.float32),
            "evidence": rng.uniform(size=(b, 3)).astype(np.float32),
        }
        labels = rng.integers(0, 2, size=b).astype(np.int64)
        batches.append((feats, labels))
    return batches


def prefetched(iterator, depth: int = 2):
    """Run `iterator` in a background thread, keeping `depth` items ready.

    The producer's exceptions are raised at the consumer; a consumer that
    stops early makes the producer stop at its next item."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()  # consumer gone: the producer drains out

    def _put(item) -> bool:
        # a bounded put, so an abandoned generator never pins this thread
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not _put(item):
                    return
            _put(sentinel)
        except BaseException as exc:  # surfaced on the consumer side
            _put(exc)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


# ----------------------------------------------------------------------
# Entry: train_and_evaluate
# ----------------------------------------------------------------------

def train_and_evaluate(
    data_dir: Optional[str] = None,
    debug_mode: bool = False,
    cfg: Optional[V1Config] = None,
    device: str = "cuda",
) -> Dict[str, float]:
    """Train the ensemble on `cfg.data_dir`'s media (75 / 25 split) or on
    dummy features, evaluating every `eval_every` epochs and after the
    last; JAX's result keys."""
    if cfg is None:
        cfg = V1Config(data_dir=data_dir, debug_mode=debug_mode)
    else:
        # positional args must not be silently ignored when cfg is given
        if data_dir is not None and cfg.data_dir is None:
            cfg.data_dir = data_dir
        if debug_mode:
            cfg.debug_mode = True
    host_rng = np.random.default_rng(cfg.seed)
    trainer = EnsembleTrainer(cfg, device=device)

    use_dummy = cfg.debug_mode or not cfg.data_dir
    extractor = dataset = None
    if not use_dummy:
        try:
            dataset = RawMediaDataset(cfg.data_dir)
            extractor = BatchFeatureExtractor(seed=cfg.seed, device=str(trainer.device))
        except FileNotFoundError:
            print("⚠️  No dataset found — training with dummy data")
            use_dummy = True

    if use_dummy:
        batches = _dummy_feature_batches(
            cfg.dummy_samples,
            min(cfg.batch_size, cfg.dummy_samples),  # never zero batches
            cfg.seed,
        )
        k = max(1, int(0.75 * len(batches)))
        train_batches, val_batches = batches[:k], batches[k:] or batches[:1]

        def epoch_train():
            losses = [trainer.train_batch(f, y, host_rng) for f, y in train_batches]
            return float(np.mean(losses))

        def evaluate():
            ys, ps = [], []
            for f, y in val_batches:
                ys.append(y)
                ps.append(trainer.predict_batch(f)[:, 1])
            y = np.concatenate(ys)
            p1 = np.concatenate(ps)
            acc = float(((p1 >= 0.5).astype(int) == y).mean())
            return acc, safe_auc(y, p1)

    else:
        n = len(dataset)
        order = host_rng.permutation(n)
        k = max(1, int(0.75 * n))  # 75/25 split
        train_idx, val_idx = order[:k], order[k:]
        train_ds = AugmentedRawMediaDataset(dataset, augment=cfg.augment, seed=cfg.seed)

        def batch_items(ds, idx_list, pad_last=False):
            for s in range(0, len(idx_list), cfg.batch_size):
                sel = list(idx_list[s : s + cfg.batch_size])
                valid = len(sel)
                if valid < cfg.batch_size:
                    if not pad_last:
                        if valid:
                            print(f"  (dropping trailing {valid}-sample train "
                                  "batch; fixed shapes)")
                        break
                    sel = sel + [sel[-1]] * (cfg.batch_size - valid)
                yield multimodal_collate([ds[int(i)] for i in sel]), valid

        def featurized(ds, idx_list, pad_last=False):
            for feats, batch, valid in extractor.stream(
                batch_items(ds, idx_list, pad_last=pad_last)
            ):
                yield (feats, batch["label"]), valid

        def epoch_train():
            losses = []
            for (feats, labels), _valid in prefetched(
                featurized(train_ds, host_rng.permutation(train_idx))
            ):
                losses.append(trainer.train_batch(feats, labels, host_rng))
            return float(np.mean(losses)) if losses else 0.0

        def evaluate():
            ys, ps = [], []
            for (feats, labels), valid in prefetched(
                featurized(dataset, val_idx, pad_last=True)
            ):
                probs = trainer.predict_batch(feats)
                ys.append(labels[:valid])
                ps.append(probs[:valid, 1])
            if not ys:
                return 0.0, 0.5
            y = np.concatenate(ys)
            p1 = np.concatenate(ps)
            acc = float(((p1 >= 0.5).astype(int) == y).mean())
            return acc, safe_auc(y, p1)

    try:
        best_acc, best_auc, no_improve = -1.0, 0.5, 0
        loss = 0.0  # stays 0.0 when epochs == 0 (eval-only call)
        last_eval = None  # (acc, auc) of the most recent in-loop evaluation
        for epoch in range(1, cfg.epochs + 1):
            loss = epoch_train()
            line = f"[v1 Epoch {epoch:02d}/{cfg.epochs}] loss={loss:.4f}"
            if epoch % cfg.eval_every == 0 or epoch == cfg.epochs:
                acc, auc = evaluate()
                last_eval = (acc, auc)
                line += f" | val acc={acc:.3f} auc={auc:.3f}"
                if acc > best_acc + 1e-6:
                    best_acc, best_auc, no_improve = acc, auc, 0
                else:
                    no_improve += 1
            print(line)
            if no_improve >= cfg.early_stop_patience:
                print("↳ Early stopping")
                break

        # the last epoch evaluates inside the loop; only early-stopped or
        # epochs = 0 runs still need a pass
        if last_eval is not None and no_improve < cfg.early_stop_patience:
            acc, auc = last_eval
        else:
            acc, auc = evaluate()
    finally:
        if extractor is not None:
            extractor.close()
    if acc > best_acc:
        best_acc, best_auc = acc, auc
    if dataset is not None:
        print(f"decode_failures: {dataset.decode_failures}")
    return {
        "val_acc": acc,
        "val_auc": auc,
        "best_val_acc": best_acc,
        "best_val_auc": best_auc,
        "loss": loss,
        "ensemble_size": cfg.ensemble_size,
        "steps": trainer.step_count,
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """The v1 CLI: the JAX entry's flags, plus `--device cuda|cpu` (cuda by
    default; `--cpu` is `--device cpu`)."""
    import argparse

    p = argparse.ArgumentParser(
        description="ultrafnd_git_tpu_torch v1 — raw-media ensemble train/eval"
    )
    p.add_argument("--data_dir", type=str, default=None,
                   help="FakeSV root with videos/ (dummy data if omitted)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--ensemble_size", type=int, default=2)
    p.add_argument("--no_mixup", action="store_true")
    p.add_argument("--no_focal", action="store_true")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--debug", action="store_true", help="Force the dummy-data path")
    add_device_args(p)
    args = resolve_cpu_flag(p.parse_args(argv))

    cfg = V1Config(
        data_dir=args.data_dir,
        epochs=args.epochs,
        batch_size=args.batch_size,
        ensemble_size=args.ensemble_size,
        mixup_alpha=0.0 if args.no_mixup else 0.2,
        use_focal=not args.no_focal,
        augment=not args.no_augment,
        eval_every=args.eval_every,
        seed=args.seed,
        debug_mode=args.debug,
    )
    results = train_and_evaluate(cfg=cfg, device=args.device)
    print("\n==== v1 Final Results ====")
    for k, v in results.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    return results


if __name__ == "__main__":
    main()
