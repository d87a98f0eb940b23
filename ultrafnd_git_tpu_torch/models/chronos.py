"""ChronosGuard: temporal-tampering cues from frame statistics
(counterpart of `models/chronos.py`).

Host numpy, the JAX module's code: per consecutive frame pair the L1
distance of 32-bin gray density histograms (`cut_scores`, a scene-cut
proxy) and the mean dense-flow magnitude (the `OpticalFlow3DCNN` cv2
ladder, else the mean |frame difference|); `extract_features` gives
[cut mean / std / max, flow mean / std / max, corr] tiled to `feat_dim`
and L2-normed; `tamper_score_from_cues` gives
0.6 * norm01(cut mean, .05, .5) + 0.4 * norm01(|flow std - flow mean|, 0, .5).
`from_config` reads `configs/model_configs/chronos_guard.yaml` with the
port's flat-YAML reader (`utils/config.py`: the GPU machine has no PyYAML).
`estimate_av_lag` is `TemporalSyncNet.estimate_av_lag`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ultrafnd_git_tpu_torch.models.temporal import TemporalSyncNet
from ultrafnd_git_tpu_torch.models.visual import (
    OpticalFlow3DCNN,
    ensure_gray,
    frames_from_input,
    resize,
)
from ultrafnd_git_tpu_torch.utils.config import load_flat_yaml


def _norm01(x: float, lo: float, hi: float) -> float:
    return float(np.clip((x - lo) / (hi - lo + 1e-9), 0.0, 1.0))


def _gray_stack(frames_or_tensor, size=(256, 256)) -> Optional[np.ndarray]:
    """Any frame container -> (T, H, W) float-free uint8 grayscale stack."""
    frames = frames_from_input(frames_or_tensor)
    if not frames or len(frames) < 2:
        return None
    return np.stack(
        [ensure_gray(resize(f, size)) for f in frames]
    )  # (T, H, W) uint8


def cut_scores(gray: np.ndarray) -> np.ndarray:
    """(T,H,W) -> (T-1,) L1 distance between consecutive density histograms."""
    hists = np.stack(
        [
            np.histogram(g, bins=32, range=(0, 255), density=True)[0]
            for g in gray
        ]
    ).astype(np.float32)  # (T, 32)
    return np.abs(np.diff(hists, axis=0)).sum(axis=1)  # (T-1,)


class ChronosGuard:
    """Scene-cut + motion-consistency tamper scoring over frame stacks."""

    def __init__(self, feat_dim: int = 128, use_opencv: bool = True):
        self.feat_dim = int(feat_dim)
        self._flow = OpticalFlow3DCNN(dim=8, use_tvl1=use_opencv)
        self.use_opencv = bool(use_opencv)

    @classmethod
    def from_config(
        cls, config_path: str = "configs/model_configs/chronos_guard.yaml"
    ) -> "ChronosGuard":
        cfg = load_flat_yaml(config_path)
        return cls(
            feat_dim=int(cfg.get("feat_dim", 128)),
            use_opencv=bool(cfg.get("use_opencv", True)),
        )

    # ------------------------------------------------------------------
    def _flow_mags(self, gray: np.ndarray) -> np.ndarray:
        """(T,H,W) -> (T-1,) mean flow magnitude per consecutive pair."""
        if self.use_opencv and _cv2_available():
            # one implementation of the pair loop + magnitude pooling
            # (shared with the flow encoder's public API)
            return self.flow_mags_from_flows(
                self._flow.flows_for_gray(gray)
            )
        # Vectorized |Δ| fallback: one subtraction over the whole stack.
        diffs = np.abs(np.diff(gray.astype(np.float32), axis=0))
        return diffs.mean(axis=(1, 2))

    def _cues(self, frames_or_tensor):
        gray = _gray_stack(frames_or_tensor)
        if gray is None:
            return None, None
        return cut_scores(gray), self._flow_mags(gray)

    # -- shared-flow path (one flow computation per clip, see
    #    OpticalFlow3DCNN.flows_for_gray) --------------------------------
    @staticmethod
    def flow_mags_from_flows(flows) -> np.ndarray:
        return np.asarray(
            [float(np.sqrt((f**2).sum(axis=-1)).mean()) for f in flows],
            dtype=np.float32,
        )

    def tamper_score_from_cues(
        self, cuts: np.ndarray, flows_mag: np.ndarray
    ) -> float:
        # NOTE on scale: cuts are L1 diffs of DENSITY histograms (the
        # reference's np.histogram(density=True), ref :57-79), whose
        # mathematical max over range 255 is ~0.25 — the (0.05, 0.5)
        # normalization window is the reference's and is kept for parity
        # even though it compresses the cut term's dynamic range.
        if cuts is None or cuts.size == 0:
            return 0.0
        flows_mag = np.asarray(flows_mag, dtype=np.float32)
        flow_term = (
            abs(float(flows_mag.std()) - float(flows_mag.mean()))
            if flows_mag.size
            else 0.0  # flow stage skipped/failed — NaN would poison aux
        )
        score = 0.6 * _norm01(float(cuts.mean()), 0.05, 0.5) + 0.4 * _norm01(
            flow_term, 0.0, 0.5
        )
        return float(np.clip(score, 0.0, 1.0))

    # ------------------------------------------------------------------
    def extract_features(self, frames_or_tensor) -> np.ndarray:
        cuts, flows = self._cues(frames_or_tensor)
        if cuts is None:
            return np.zeros(self.feat_dim, dtype=np.float32)
        corr = (
            float(np.corrcoef(cuts, flows)[0, 1]) if cuts.size > 3 else 0.0
        )
        if not np.isfinite(corr):
            corr = 0.0
        v = np.asarray(
            [
                cuts.mean(), cuts.std(), cuts.max(),
                flows.mean(), flows.std(), flows.max(),
                corr,
            ],
            dtype=np.float32,
        )
        reps = int(np.ceil(self.feat_dim / v.shape[0]))
        v = np.tile(v, reps)[: self.feat_dim]
        return (v / (np.linalg.norm(v) + 1e-9)).astype(np.float32)

    def extract_features_batch(
        self, clips: Sequence
    ) -> np.ndarray:
        return np.stack([self.extract_features(c) for c in clips])

    # ------------------------------------------------------------------
    def temporal_tamper_score(
        self, frames_or_tensor, audio: Optional[np.ndarray] = None
    ) -> float:
        cuts, flows = self._cues(frames_or_tensor)
        if cuts is None:
            return 0.0
        return self.tamper_score_from_cues(cuts, flows)

    def temporal_tamper_score_batch(self, clips: Sequence) -> np.ndarray:
        return np.asarray(
            [self.temporal_tamper_score(c) for c in clips], dtype=np.float32
        )

    # ------------------------------------------------------------------
    @staticmethod
    def estimate_av_lag(
        audio_env: np.ndarray,
        mouth_open: np.ndarray,
        sr: float = 16000.0,
        fps: "float | None" = None,
        max_lag_s: float = 0.5,
    ) -> float:
        return TemporalSyncNet.estimate_av_lag(
            audio_env, mouth_open, sr=sr, fps=fps, max_lag_s=max_lag_s
        )


def _cv2_available() -> bool:
    try:
        import cv2  # noqa: F401

        return True
    except Exception:
        return False
