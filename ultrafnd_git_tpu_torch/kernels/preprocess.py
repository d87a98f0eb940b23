"""The device CV stage of the v1 pipeline: dense flow and the chronos cues
of decoded clips, in torch on the caller's device (counterpart of
`kernels/preprocess.py`).

The JAX module is one jitted XLA program with no `pallas_call`, so this is
a module of plain torch ops, not a hand-written kernel. From decoded uint8
clips (or gray, or float [0, 1] with `input_scale` 255) it computes:

  * `gray_resize`: channels-last or planar RGB -> gray (0.2989, 0.5870,
    0.1140 in f32), resized to the 256 raster only when the frames are
    not 256 x 256, by `jax.image.resize(..., "bilinear")`'s own weights
    (triangle kernel, widened when downsampling, each output's weights
    normalised), built on the host and applied as two matmuls;
  * `block_match_flow`: at half raster (`_pyr_down`, a 2 x 2 mean), the
    8 x 8-block SAD of every displacement in [-7, 7]^2 against the
    edge-padded next frame, + 1e-3 * (|dy| + |dx|) so that exact ties take
    the smallest displacement, the first argmin, then a parabola through
    the SAD neighbours along each axis (none at the search border or on an
    exact match); the SAD is computed one dy at a time, every dx of it at
    once (an unfolded view of the padded frame);
  * `flow_stats`: per temporal-pyramid segment [mean, std (ddof 0), max]
    of the time-averaged magnitude and the 8-bin histogram of the
    time-averaged angle (weighted raster^2 / grid cells), tiled to `dim`
    and L2-normed (`models/visual.OpticalFlow3DCNN._pool_flow`'s layout);
  * `density_histograms` / `cut_scores_device`: 32-bin density
    histograms over (0, 255) and their consecutive L1 distances
    (`models/chronos.cut_scores`); counts by `scatter_add_`, exact.

`DeviceCVStage.dispatch` uploads a batch through pinned memory and
enqueues the stage without waiting for the device (no `.item()`, no
boolean indexing, no `nonzero`), so the host's work after it (ELA's JPEG
pass) runs while the upload and the stage do; `finalize` copies the cues
back and adds ChronosGuard's tamper score on the host.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ultrafnd_git_tpu_torch.utils.device import to_device

RASTER = 256  # model raster (every frame is resized to 256 x 256)
GRAY = (0.2989, 0.5870, 0.1140)


# ----------------------------------------------------------------------
# Color / raster normalization
# ----------------------------------------------------------------------

def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 weights of `jax.image.resize`'s bilinear
    method with antialias (`scale_and_translate`'s `compute_weight_mat`
    with the triangle kernel and no translation), in the same f32 steps."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps)),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def gray_resize(frames: torch.Tensor, size: int = RASTER) -> torch.Tensor:
    """(B, T, 3, H, W) planar, (B, T, H, W, 3) channels-last or already
    gray (B, T, H, W), uint8 or float -> (B, T, size, size) f32 gray."""
    if frames.ndim == 4:  # already grayscale
        g = frames.float()
    else:
        if frames.shape[-1] == 3 and frames.ndim == 5:
            frames = frames.permute(0, 1, 4, 2, 3)
        f = frames.float()
        g = GRAY[0] * f[:, :, 0] + GRAY[1] * f[:, :, 1] + GRAY[2] * f[:, :, 2]
    h, w = g.shape[2], g.shape[3]
    if h != size:
        g = torch.matmul(to_device(torch.from_numpy(resize_weights(h, size)), g.device).T, g)
    if w != size:
        g = torch.matmul(g, to_device(torch.from_numpy(resize_weights(w, size)), g.device))
    return g


# ----------------------------------------------------------------------
# Block-matching dense flow
# ----------------------------------------------------------------------

def _pyr_down(x: torch.Tensor) -> torch.Tensor:
    """2x average-pool downsample over the last two dims (a trailing odd
    row or column is dropped); the window summed in row-major order."""
    *lead, h, w = x.shape
    v = x[..., : h // 2 * 2, : w // 2 * 2].reshape(*lead, h // 2, 2, w // 2, 2)
    return (v[..., 0, :, 0] + v[..., 0, :, 1] + v[..., 1, :, 0] + v[..., 1, :, 1]) * 0.25


def block_match_flow(
    g0: torch.Tensor,
    g1: torch.Tensor,
    radius: int = 7,
    block: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block integer + subpixel flow: (P, H, W) -> u, v (P, H/b, W/b)."""
    p, h, w = g0.shape
    n = 2 * radius + 1
    gh, gw = h // block, w // block
    g1p = F.pad(g1[:, None], (radius, radius, radius, radius), mode="replicate")[:, 0]
    rows: List[torch.Tensor] = []
    for dy in range(-radius, radius + 1):
        band = g1p[:, radius + dy : radius + dy + h]  # (P, H, W + 2r)
        shifted = band.unfold(2, w, 1)  # (P, H, n, W): window j is dx = j - r
        diff = (g0[:, :, None, :] - shifted).abs()
        sad = diff[:, : gh * block, :, : gw * block].reshape(p, gh, block, n, gw, block)
        rows.append(sad.sum(dim=(2, 5)))  # (P, gh, n, gw)
    # (n_dy, n_dx, P, gh, gw) -> (n * n, P, gh, gw), flat index (dy + r) * n + dx + r
    vol = torch.stack(rows).permute(0, 3, 1, 2, 4).reshape(n * n, p, gh, gw)
    # tiny distance penalty: exact SAD ties (static scenes) resolve to the
    # smallest displacement, not argmin's first; f32(1e-3 * k), the product
    # taken in f64 as JAX's Python scalar is, and made on the device (a copy
    # from the host would wait for the SAD passes queued before it)
    d = torch.arange(-radius, radius + 1, dtype=torch.float64, device=vol.device).abs()
    penalty = (1e-3 * (d[:, None] + d[None, :])).reshape(-1).float()
    vol = vol + penalty[:, None, None, None]

    best = torch.argmin(vol, dim=0)  # (P, gh, gw) flat displacement index
    by = torch.div(best, n, rounding_mode="floor") - radius
    bx = best % n - radius
    mid = torch.gather(vol, 0, best[None])[0]

    def _subpixel(axis_idx: torch.Tensor, stride: int) -> torch.Tensor:
        """Parabola vertex through the SAD at best -+ stride along one
        displacement axis; 0 on the search border and on an exact match."""
        lo = torch.gather(vol, 0, (best - stride).clamp_min(0)[None])[0]
        hi = torch.gather(vol, 0, (best + stride).clamp_max(n * n - 1)[None])[0]
        denom = lo - 2.0 * mid + hi
        zero = torch.zeros((), dtype=vol.dtype, device=vol.device)
        frac = torch.where(denom > 1e-6, 0.5 * (lo - hi) / denom.clamp_min(1e-6), zero)
        frac = torch.where(mid <= 1e-3, zero, frac)
        on_border = (axis_idx <= -radius) | (axis_idx >= radius)
        return torch.where(on_border, zero, frac.clamp(-0.5, 0.5))

    v = by.float() + _subpixel(by, n)
    u = bx.float() + _subpixel(bx, 1)
    return u, v


# ----------------------------------------------------------------------
# Pooled statistics
# ----------------------------------------------------------------------

def _segment_bounds(t: int, n_pyr: int):
    """(a, b) slices of `OpticalFlow3DCNN._pool_flow`'s pyramid, clamped
    so that a short clip (t < parts) never gets an empty segment."""
    bounds = []
    for level in range(n_pyr):
        parts = 2 ** level
        seg = max(1, t // parts)
        for p in range(parts):
            a = min(p * seg, t - 1)
            b = t if p == parts - 1 else min((p + 1) * seg, t)
            bounds.append((a, max(b, a + 1)))
    return bounds


def _counts(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """(R, K) int64 bin indices in [0, bins) -> (R, bins) f32 counts."""
    out = torch.zeros(idx.shape[0], bins, dtype=torch.float32, device=idx.device)
    return out.scatter_add_(1, idx, torch.ones(idx.shape, dtype=torch.float32,
                                               device=idx.device))


def flow_stats(
    mag: torch.Tensor,
    ang: torch.Tensor,
    n_pyr: int = 3,
    dim: int = 256,
    hist_scale: float = 1.0,
) -> torch.Tensor:
    """(B, T-1, H, W) magnitude and angle in [0, 1] -> (B, dim) pooled
    features (`_pool_flow`'s layout; one row per clip). `hist_scale`
    weighs a coarser grid's counts as the full raster's."""
    b = mag.shape[0]
    feats = []
    for a, e in _segment_bounds(mag.shape[1], n_pyr):
        m = mag[:, a:e].mean(dim=1).reshape(b, -1)
        an = ang[:, a:e].mean(dim=1).reshape(b, -1)
        mean = m.mean(dim=1, keepdim=True)
        std = ((m - mean) ** 2).mean(dim=1, keepdim=True).sqrt()  # ddof 0, as jnp.std
        feats += [mean, std, m.amax(dim=1, keepdim=True)]
        idx = torch.floor(an * 8.0).clamp(0, 7).long()
        feats.append(_counts(idx, 8) * hist_scale)
    flat = torch.cat(feats, dim=1)  # (B, 11 * segments)
    reps = -(-dim // flat.shape[1])  # ceil
    tiled = flat.repeat(1, reps)[:, :dim]
    return tiled / (torch.linalg.vector_norm(tiled, dim=1, keepdim=True) + 1e-9)


def density_histograms(gray: torch.Tensor, bins: int = 32) -> torch.Tensor:
    """(..., H, W) gray in [0, 255] -> (..., bins) density histograms
    (numpy.histogram(range=(0, 255), density=True) semantics)."""
    *lead, h, w = gray.shape
    width = 255.0 / bins
    idx = torch.floor(gray / width).clamp(0, bins - 1).long().reshape(-1, h * w)
    return (_counts(idx, bins) / (h * w * width)).reshape(*lead, bins)


def cut_scores_device(gray: torch.Tensor, bins: int = 32) -> torch.Tensor:
    """(..., T, H, W) -> (..., T-1) L1 distances of consecutive density
    histograms (`models/chronos.cut_scores`)."""
    hists = density_histograms(gray, bins)
    return (hists[..., 1:, :] - hists[..., :-1, :]).abs().sum(dim=-1)


# ----------------------------------------------------------------------
# The stage
# ----------------------------------------------------------------------

def device_cv_stage(
    frames: torch.Tensor,
    flow_dim: int = 256,
    n_pyr: int = 3,
    radius: int = 7,
    block: int = 8,
    input_scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Decoded clips (planar, channels-last or gray; uint8, or float with
    `input_scale` = 255 for [0, 1]) on any device -> {flow_feat (B,
    flow_dim), cuts (B, T-1), flow_mags (B, T-1)} on that device.

    Flow runs at half raster: a +-`radius` search there covers +-2 *
    `radius` px of full-raster motion; block flow is scaled x2 back to
    full-raster pixels."""
    gray = gray_resize(frames)  # (B, T, R, R)
    if input_scale != 1.0:
        gray = gray * input_scale
    b, t = gray.shape[:2]

    half = _pyr_down(gray)  # (B, T, R/2, R/2)
    r2 = RASTER // 2
    g0 = half[:, :-1].reshape(b * (t - 1), r2, r2)
    g1 = half[:, 1:].reshape(b * (t - 1), r2, r2)
    u, v = block_match_flow(g0, g1, radius=radius, block=block)
    u = 2.0 * u  # full-raster pixel units
    v = 2.0 * v
    gh, gw = u.shape[-2:]
    mag = torch.sqrt(u * u + v * v).reshape(b, t - 1, gh, gw)
    ang = ((torch.atan2(v, u) + np.pi) / (2.0 * np.pi)).reshape(b, t - 1, gh, gw)

    # grid counts weigh (RASTER^2 / grid cells) each, as the host ladder's
    # full-raster histograms do inside the L2-normalised feature
    hist_scale = float(RASTER * RASTER) / float(gh * gw)
    flow_feat = flow_stats(mag, ang, n_pyr=n_pyr, dim=flow_dim, hist_scale=hist_scale)
    cuts = cut_scores_device(gray)
    flow_mags = mag.mean(dim=(-1, -2))
    return {"flow_feat": flow_feat, "cuts": cuts, "flow_mags": flow_mags}


class DeviceCVStage:
    """numpy clips in, numpy cues out, on `device` (cuda by default).

    Takes channels-last (B, T, H, W, 3) clips (the collate contract) or
    gray (B, T, H, W); uint8 is taken as [0, 255], float as [0, 1]. The
    tamper score is ChronosGuard's combination of the cues, on the host.
    """

    def __init__(
        self,
        flow_dim: int = 256,
        n_pyr: int = 3,
        radius: int = 7,
        block: int = 8,
        device: str = "cuda",
    ):
        from ultrafnd_git_tpu_torch.utils.device import resolve_device

        self.flow_dim = int(flow_dim)
        self.n_pyr = int(n_pyr)
        self.radius = int(radius)
        self.block = int(block)
        self.device = resolve_device(device)

    def dispatch(self, frames: np.ndarray) -> Dict[str, torch.Tensor]:
        """Upload `frames` and enqueue the stage; the cues come back as
        device tensors, without waiting for the device."""
        arr = np.ascontiguousarray(frames)
        scale = 1.0 if arr.dtype == np.uint8 else 255.0
        with torch.inference_mode():
            return device_cv_stage(
                to_device(torch.from_numpy(arr), self.device),
                flow_dim=self.flow_dim,
                n_pyr=self.n_pyr,
                radius=self.radius,
                block=self.block,
                input_scale=scale,
            )

    def finalize(self, out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Copy the cues back and add the host tamper score."""
        from ultrafnd_git_tpu_torch.models.chronos import ChronosGuard

        host = {k: val.cpu().numpy() for k, val in out.items()}
        guard = ChronosGuard.__new__(ChronosGuard)  # combination only
        host["tamper"] = np.asarray(
            [guard.tamper_score_from_cues(host["cuts"][i], host["flow_mags"][i])
             for i in range(host["cuts"].shape[0])],
            dtype=np.float32,
        )
        return host

    def __call__(self, frames: np.ndarray) -> Dict[str, np.ndarray]:
        return self.finalize(self.dispatch(frames))
