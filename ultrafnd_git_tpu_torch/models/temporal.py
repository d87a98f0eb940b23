"""Temporal alignment (counterpart of `models/temporal.py:25-67`, `:120-244`).

`TemporalAlignMLP` is the module; `TemporalSyncNet` owns one with fixed
weights and applies it to the whole corpus, as `build_feature_cache`
does. Nobody trains it, so its initial draw is the feature map: U(+-1 /
sqrt(fan_in)) weights and biases, the JAX package's distribution, from a
`torch.Generator` seeded with `seed`. torch cannot repeat the JAX
package's `jax.random.PRNGKey(seed)` draw, so a cache built here differs
from a JAX-built one in `temporal`, `aux[:, 0]` and `evidence[:, 2]`
unless the JAX weights are passed in as `state_dict`
(`utils/transfer.align_state_dict`). Its two host helpers, `delay_score`
(a length-mismatch proxy) and `estimate_av_lag` (FFT cross-correlation,
positive when the audio arrives late), are the JAX numpy code.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.models.initializers import jax_init_


def _pad_or_trunc(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-pad or truncate the last axis to `dim`."""
    d = v.shape[-1]
    if d == dim:
        return v
    if d > dim:
        return v[..., :dim]
    return F.pad(v, (0, dim - d))


def cosine01(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Row-wise cosine similarity in [-1, 1], keepdims."""
    xn = x / (x.norm(dim=-1, keepdim=True) + eps)
    yn = y / (y.norm(dim=-1, keepdim=True) + eps)
    return (xn * yn).sum(dim=-1, keepdim=True)


class TemporalAlignMLP(nn.Module):
    """[t, v, t-v, t*v, cos] -> MLP(4D+1 -> 2*out -> out), tanh GELU.

    The JAX module uses Flax's default `nn.gelu`, the tanh approximation
    (unlike fusion, classifier and GCN, which use exact erf).
    """

    def __init__(self, in_dim: int = 768, out_dim: int = 256):
        super().__init__()
        self.in_dim = in_dim
        self.proj_in = nn.Linear(4 * in_dim + 1, 2 * out_dim)
        self.proj_out = nn.Linear(2 * out_dim, out_dim)

    def forward(self, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        v = _pad_or_trunc(v, self.in_dim)
        t = _pad_or_trunc(t, self.in_dim)
        feat = torch.cat([t, v, t - v, t * v, cosine01(t, v)], dim=-1)
        h = F.gelu(self.proj_in(feat), approximate="tanh")
        return self.proj_out(h)


class TemporalSyncNet:
    """A fixed `TemporalAlignMLP` applied row-wise to whole corpora on
    `device`; numpy in, numpy out."""

    def __init__(self, in_dim: int = 768, out_dim: int = 256, seed: int = 0,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device: str = "cpu"):
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.module = TemporalAlignMLP(self.in_dim, self.out_dim)
        if state_dict is None:
            jax_init_("align", self.module, torch.Generator().manual_seed(int(seed)))
        else:
            self.module.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                         for k, v in state_dict.items()})
        self.device = torch.device(device)
        self.module.to(self.device).eval()

    @classmethod
    def around(cls, module: TemporalAlignMLP) -> "TemporalSyncNet":
        """A TemporalSyncNet that applies `module` itself (no draw), on the
        device its weights lie on."""
        net = cls.__new__(cls)
        net.in_dim, net.out_dim = module.in_dim, module.proj_out.out_features
        net.module = module
        net.device = module.proj_out.weight.device
        return net

    def _apply(self, t: np.ndarray, v: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = self.module(torch.as_tensor(t, dtype=torch.float32).to(self.device),
                              torch.as_tensor(v, dtype=torch.float32).to(self.device))
            return out.cpu().numpy()

    def align_batch(self, T: np.ndarray, V: np.ndarray) -> np.ndarray:
        """(N, in_dim) x (N, Dv) -> (N, out_dim)."""
        return self._apply(T, _pad_or_trunc(torch.as_tensor(V, dtype=torch.float32),
                                            self.in_dim))

    def align_batch_pair(self, T: np.ndarray, V: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(align(T, V), align(T, T)) as one 2N-row pass (exact: the MLP
        works row by row)."""
        t = torch.as_tensor(T, dtype=torch.float32)
        v = _pad_or_trunc(torch.as_tensor(V, dtype=torch.float32), self.in_dim)
        both = self._apply(torch.cat([t, t]), torch.cat([v, t]))
        n = t.shape[0]
        return both[:n], both[n:]

    @staticmethod
    def delay_score(audio_len: int, video_len: int) -> float:
        """Length-mismatch proxy in [0,1]; 0 = matched."""
        a = float(max(0, audio_len))
        v = float(max(0, video_len))
        m = max(1.0, max(a, v))
        return float(abs(a - v) / m)

    @staticmethod
    def estimate_av_lag(
        audio_envelope: np.ndarray,
        mouth_open: np.ndarray,
        sr: float = 16000.0,
        fps: Optional[float] = None,
        max_lag_s: float = 0.5,
    ) -> float:
        """FFT cross-correlation A/V lag in seconds.

        Sign convention: **positive = the audio arrives late** (delayed
        relative to the video signal); negative = the audio leads.

        `fps`: sample rate of `mouth_open` when it is a per-frame video
        signal; it is resampled to `sr` before correlating. None means
        both signals already share rate `sr`.
        """
        a = np.asarray(audio_envelope, dtype=np.float32).ravel()
        m = np.asarray(mouth_open, dtype=np.float32).ravel()
        if fps is not None and fps > 0 and fps != sr and m.size > 1:
            t_m = np.arange(m.size) / float(fps)
            t_target = np.arange(int(t_m[-1] * sr) + 1) / float(sr)
            m = np.interp(t_target, t_m, m).astype(np.float32)
        L = min(len(a), len(m))
        if L < 4:
            return 0.0
        a = (a[:L] - a[:L].mean()) / (a[:L].std() + 1e-9)
        m = (m[:L] - m[:L].mean()) / (m[:L].std() + 1e-9)

        n = 1
        while n < 2 * L:
            n <<= 1
        xc = np.fft.irfft(np.fft.rfft(a, n) * np.conj(np.fft.rfft(m, n)), n)
        xc = np.concatenate([xc[-(L - 1):], xc[:L]])

        max_lag = int(max_lag_s * sr)
        center = len(xc) // 2
        lo = max(0, center - max_lag)
        hi = min(len(xc), center + max_lag + 1)
        lag_samples = (lo + int(np.argmax(xc[lo:hi]))) - center
        return float(lag_samples / sr)
