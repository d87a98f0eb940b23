"""Visual features: motion statistics and forgery (ELA / LBP) cues, the
frame and text-proxy rungs (counterpart of `models/visual.py`).

Host code, the JAX module's line for line:
  * frame normalisers (`as_numpy_frame`, `ensure_gray`, `resize`,
    `frames_from_input`): HWC / CHW, uint8 / float / torch in, uint8 RGB
    out; cv2 where it imports, else the numpy luma and nearest-neighbour;
  * `OpticalFlow3DCNN`: dense flow per consecutive gray pair by TV-L1
    (where `cv2.optflow` exists), else Farneback, else the frame
    difference; pooled per temporal-pyramid segment into magnitude
    mean / std / max and an 8-bin orientation histogram, tiled to `dim`
    and L2-normed (`kernels/preprocess.py` is its device stage);
  * `DeepForgeryDetector.ela_lbp`: the middle frame's JPEG re-encode error
    (a copy, so zero error, without cv2) and a ones-count LBP histogram;
  * `FaceWarpAnalyzer.score`: Sobel-gradient spread and ELA in [0, 1].
Strings take the stable-hash rungs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ultrafnd_git_tpu_torch.ops.hashing import (
    hash_embed,
    hash_embed_batch,
    stable_unit_score,
)

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


# ----------------------------------------------------------------------
# Frame normalization utilities
# ----------------------------------------------------------------------

def as_numpy_frame(x) -> Optional[np.ndarray]:
    """Normalize one frame to uint8 RGB [H, W, 3] (accepts CHW/float/torch)."""
    if x is None:
        return None
    if hasattr(x, "detach"):
        arr = x.detach().cpu().numpy()
    else:
        arr = np.asarray(x)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[2] != 3:
        arr = np.transpose(arr, (1, 2, 0))
    if arr.dtype != np.uint8:
        if arr.max() <= 1.0 + 1e-6:
            arr = (arr * 255.0).clip(0, 255).astype(np.uint8)
        else:
            arr = arr.clip(0, 255).astype(np.uint8)
    return arr


def ensure_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img
    if img.ndim == 3 and img.shape[-1] == 1:
        # single-channel frames are accepted by as_numpy_frame's CHW
        # check; cvtColor would reject them and the luma math would index
        # out of bounds
        return img[..., 0]
    if _HAS_CV2:
        return cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return (0.2989 * r + 0.5870 * g + 0.1140 * b).astype(np.uint8)


def resize(img: np.ndarray, size=(256, 256)) -> np.ndarray:
    if _HAS_CV2:
        return cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    # vectorized nearest-neighbor fallback
    h, w = img.shape[:2]
    ys = (np.arange(size[1]) * h // size[1]).astype(int)
    xs = (np.arange(size[0]) * w // size[0]).astype(int)
    return img[ys][:, xs]


def frames_from_input(frames_or_text) -> Optional[List[np.ndarray]]:
    """Normalize input to a list of RGB uint8 frames, or None for text."""
    if isinstance(frames_or_text, (list, tuple)):
        frames = [as_numpy_frame(f) for f in frames_or_text]
        frames = [f for f in frames if f is not None]
        return frames or None

    if hasattr(frames_or_text, "detach"):
        arr = frames_or_text.detach().cpu().numpy()
    elif isinstance(frames_or_text, np.ndarray):
        arr = frames_or_text
    else:
        return None

    if arr.ndim == 4 and arr.shape[-1] == 3:
        return [as_numpy_frame(arr[i]) for i in range(arr.shape[0])]
    return None


def _fit_and_norm(v: np.ndarray, dim: int) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    if v.shape[0] < dim:
        v = np.tile(v, int(np.ceil(dim / v.shape[0])))[:dim]
    else:
        v = v[:dim]
    return (v / (np.linalg.norm(v) + 1e-9)).astype(np.float32)


# ----------------------------------------------------------------------
# Motion features
# ----------------------------------------------------------------------

class OpticalFlow3DCNN:
    """Pooled motion features over consecutive frames (fixed dim, default 256).

    (The reference keeps this historical misnomer — there is no CNN; the
    class pools flow statistics. Name preserved for API parity.)
    """

    def __init__(self, dim: int = 256, n_pyramid_levels: int = 3, use_tvl1: bool = True):
        self.dim = int(dim)
        self.n_pyr = int(n_pyramid_levels)
        self.use_tvl1 = bool(
            use_tvl1
            and _HAS_CV2
            and hasattr(cv2, "optflow")
            and hasattr(cv2.optflow, "DualTVL1OpticalFlow_create")
        )
        self._tvl1 = None
        if self.use_tvl1:
            try:
                self._tvl1 = cv2.optflow.DualTVL1OpticalFlow_create()
            except Exception:
                self.use_tvl1 = False

    def _flow_pair(self, g0: np.ndarray, g1: np.ndarray) -> np.ndarray:
        if self.use_tvl1 and self._tvl1 is not None:
            try:
                return self._tvl1.calc(g0, g1, None)
            except Exception:
                pass
        if _HAS_CV2:
            try:
                return cv2.calcOpticalFlowFarneback(
                    g0, g1, None,
                    pyr_scale=0.5, levels=3, winsize=15,
                    iterations=3, poly_n=5, poly_sigma=1.2, flags=0,
                )
            except Exception:
                pass
        flow = np.zeros((*g0.shape, 2), dtype=np.float32)
        flow[..., 1] = g1.astype(np.float32) - g0.astype(np.float32)
        return flow

    def _pool_flow(self, flows: List[np.ndarray]) -> np.ndarray:
        if not flows:
            return np.zeros(self.dim, dtype=np.float32)

        fx = np.stack([f[..., 0] for f in flows])
        fy = np.stack([f[..., 1] for f in flows])
        mags = np.sqrt(fx * fx + fy * fy)  # [T-1, H, W]
        angs = (np.arctan2(fy, fx) + np.pi) / (2 * np.pi)  # [0, 1]

        feat: List[float] = []
        T = mags.shape[0]
        for level in range(self.n_pyr):
            parts = 2**level
            seg = max(1, T // parts)
            for p in range(parts):
                # clamp so short clips (T < parts) never yield an empty
                # segment — an empty mean is NaN and _fit_and_norm would
                # tile it across the whole feature vector
                a = min(p * seg, T - 1)
                b = T if p == parts - 1 else min((p + 1) * seg, T)
                b = max(b, a + 1)
                m = mags[a:b].mean(axis=0)
                ang = angs[a:b].mean(axis=0)
                feat += [m.mean(), m.std(), m.max()]
                hist, _ = np.histogram(ang, bins=8, range=(0.0, 1.0))
                feat += list(hist.astype(np.float32))

        return _fit_and_norm(np.asarray(feat, dtype=np.float32), self.dim)

    def flows_for_gray(self, gray: np.ndarray) -> List[np.ndarray]:
        """(T, H, W) grayscale stack -> T-1 dense flow fields.

        Exposed so ChronosGuard and the feature pipeline can share ONE
        flow computation per clip — flow dominates host preprocessing
        (~0.5 s/clip at 30x256^2), and the reference computed it twice.
        """
        return [
            self._flow_pair(gray[i], gray[i + 1])
            for i in range(gray.shape[0] - 1)
        ]

    def pool_flows(self, flows: List[np.ndarray]) -> np.ndarray:
        """Public pooling over precomputed flow fields."""
        return self._pool_flow(flows)

    def extract(self, frames_or_text) -> np.ndarray:
        if isinstance(frames_or_text, str):
            return hash_embed(frames_or_text, self.dim, max_tokens=self.dim)
        frames = frames_from_input(frames_or_text)
        if not frames or len(frames) < 2:
            return np.zeros(self.dim, dtype=np.float32)
        gray = np.stack(
            [ensure_gray(resize(f, (256, 256))) for f in frames]
        )
        return self._pool_flow(self.flows_for_gray(gray))

    def extract_text_batch(self, texts: Sequence[str]) -> np.ndarray:
        return hash_embed_batch(texts, self.dim, max_tokens=self.dim)


# ----------------------------------------------------------------------
# ELA + LBP forgery cues
# ----------------------------------------------------------------------

class DeepForgeryDetector:
    """ELA magnitude stats + LBP histogram pooled to a fixed vector."""

    def __init__(
        self,
        dim: int = 256,
        ela_quality: int = 85,
        ela_scale: float = 1.0,
        lbp_radius: int = 1,
        lbp_points: int = 8,
    ):
        self.dim = int(dim)
        self.ela_quality = int(ela_quality)
        self.ela_scale = float(ela_scale)
        self.lbp_radius = int(lbp_radius)
        self.lbp_points = int(lbp_points)

    def _jpeg_reencode(self, rgb: np.ndarray) -> np.ndarray:
        if not _HAS_CV2:
            return rgb.copy()
        ok, enc = cv2.imencode(
            ".jpg",
            cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
            [int(cv2.IMWRITE_JPEG_QUALITY), self.ela_quality],
        )
        if not ok:
            return rgb.copy()
        dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)
        if dec is None:
            return rgb.copy()
        return cv2.cvtColor(dec, cv2.COLOR_BGR2RGB)

    def ela_map(self, rgb: np.ndarray) -> np.ndarray:
        rec = self._jpeg_reencode(rgb)
        diff = np.abs(rgb.astype(np.float32) - rec.astype(np.float32))
        return np.clip(diff * self.ela_scale, 0, 255).astype(np.uint8)

    def _lbp_hist(self, gray: np.ndarray) -> np.ndarray:
        """Uniform-LBP-style histogram; vectorized neighbor comparison."""
        g = gray.astype(np.float32)
        c = g[1:-1, 1:-1]
        shifts = [
            g[:-2, :-2], g[:-2, 1:-1], g[:-2, 2:],
            g[1:-1, 2:], g[2:, 2:], g[2:, 1:-1],
            g[2:, :-2], g[1:-1, :-2],
        ][: self.lbp_points]
        codes = np.stack([(s > c) for s in shifts], axis=0)  # (P, H-2, W-2)
        counts = codes.sum(axis=0).astype(np.int32)  # 0..P "ones count"
        # uniform-pattern proxy: ones-count bins + one catch-all (P+2 bins)
        n_bins = self.lbp_points + 2
        hist, _ = np.histogram(counts, bins=n_bins, range=(0, n_bins), density=True)
        return hist.astype(np.float32)

    def ela_lbp(self, image_or_frames_or_text) -> np.ndarray:
        if isinstance(image_or_frames_or_text, str):
            return hash_embed(image_or_frames_or_text, self.dim, max_tokens=self.dim)

        frames = frames_from_input(image_or_frames_or_text)
        img = (
            frames[len(frames) // 2]
            if frames
            else as_numpy_frame(image_or_frames_or_text)
        )
        if img is None:
            return np.zeros(self.dim, dtype=np.float32)

        img = resize(img, (256, 256))
        ela = self.ela_map(img)
        gray = ensure_gray(ela)

        stats = np.array(
            [ela.mean(), ela.std(), ela.max(), ela.min()], dtype=np.float32
        )
        return _fit_and_norm(
            np.concatenate([stats, self._lbp_hist(gray)]), self.dim
        )

    def ela_lbp_text_batch(self, texts: Sequence[str]) -> np.ndarray:
        return hash_embed_batch(texts, self.dim, max_tokens=self.dim)


class FaceWarpAnalyzer:
    """Quick warp/artifact anomaly score in [0,1]."""

    def score(self, image_or_frames_or_text) -> float:
        if isinstance(image_or_frames_or_text, str):
            return stable_unit_score(image_or_frames_or_text)

        frames = frames_from_input(image_or_frames_or_text)
        img = (
            frames[len(frames) // 2]
            if frames
            else as_numpy_frame(image_or_frames_or_text)
        )
        if img is None:
            return 0.0

        img = resize(img, (256, 256))
        gray = ensure_gray(img)

        if _HAS_CV2:
            sx = cv2.Sobel(gray, cv2.CV_32F, 1, 0, ksize=3)
            sy = cv2.Sobel(gray, cv2.CV_32F, 0, 1, ksize=3)
        else:
            g = gray.astype(np.float32)
            sx = np.zeros_like(g)
            sy = np.zeros_like(g)
            sx[:, 1:] = g[:, 1:] - g[:, :-1]
            sy[1:, :] = g[1:, :] - g[:-1, :]
        grad_mag = np.sqrt(sx * sx + sy * sy)

        g_mean = float(grad_mag.mean())
        g_std = float(grad_mag.std())
        ela_mean = float(DeepForgeryDetector(dim=16).ela_map(img).mean()) / 255.0

        score = 0.5 * np.tanh(g_std / (g_mean + 1e-6)) + 0.5 * ela_mean
        return float(np.clip(score, 0.0, 1.0))
