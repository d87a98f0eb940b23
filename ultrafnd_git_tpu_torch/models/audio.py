"""Audio features: the waveform and text-proxy rungs of the JAX audio
encoders (counterpart of `models/audio.py`).

Host numpy, the JAX module's code: `ensure_mono_16k` (linear-interpolation
resample), `stft_magnitude` (Hann-windowed frames, rfft), `mel_filterbank`
(HTK scale), the spectral descriptors, `MelSpectrogramGenerator` (dB
relative to the maximum), `SpectralForensics` and `VoiceCloneDetector`.

`SpectralForensics` is the ladder the JAX encoder runs without HuggingFace
weights (`ULTRAFND_DISABLE_HF=1`): a string -> its stable-hash embedding;
a waveform -> the spectral statistics (`_spectral_stats`: magnitude,
contrast, flatness, centroid, roll-off, zero crossings, tiled to `dim`
and L2-normed), or the four STFT statistics should those raise; an empty
waveform -> zeros. Its wav2vec2 rung needs outside weights and is not
ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

from ultrafnd_git_tpu_torch.ops.hashing import (
    hash_embed,
    hash_embed_batch,
    stable_unit_score,
)

ArrayLike = Union[np.ndarray, "object"]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):  # torch tensor without importing torch
        return x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def ensure_mono_16k(wave, sr: int) -> Tuple[np.ndarray, int]:
    """Mono float32 waveform; naive polyphase-free resample to 16 kHz."""
    wav = _to_numpy(wave).astype(np.float32)
    if wav.ndim == 2:  # [C, T] -> mono
        wav = wav.mean(axis=0)
    if sr != 16000 and sr > 0 and wav.size:
        # linear-interpolation resample (reference used librosa; this is the
        # dependency-free equivalent and is exact for band-limited ratios)
        n_out = int(round(wav.size * 16000.0 / sr))
        if n_out > 1:
            xp = np.linspace(0.0, 1.0, wav.size, endpoint=False)
            xq = np.linspace(0.0, 1.0, n_out, endpoint=False)
            wav = np.interp(xq, xp, wav).astype(np.float32)
            sr = 16000
    return wav, sr


def stft_magnitude(
    wav: np.ndarray, n_fft: int = 400, hop: int = 160
) -> np.ndarray:
    """|STFT| via strided framing + rfft: (n_fft//2+1, n_frames)."""
    if wav.size < n_fft:
        wav = np.pad(wav, (0, n_fft - wav.size))
    n_frames = 1 + (wav.size - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(n_fft)[None, :]
    return np.abs(np.fft.rfft(frames, axis=-1)).T.astype(np.float32)


def mel_filterbank(
    sr: int = 16000, n_fft: int = 400, n_mels: int = 64
) -> np.ndarray:
    """Triangular mel filterbank (n_mels, n_fft//2+1), HTK mel scale."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_bins)
    mel_pts = mel_to_hz(np.linspace(0, hz_to_mel(sr / 2), n_mels + 2))
    fb = np.zeros((n_mels, n_bins), dtype=np.float32)
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


# -- shared spectral descriptors (one copy; used by SpectralForensics
#    and VoiceCloneDetector) ---------------------------------------------

def spectral_flatness(S: np.ndarray) -> np.ndarray:
    """Per-frame geometric/arithmetic magnitude ratio."""
    logS = np.log(S + 1e-9)
    return np.exp(logS.mean(axis=0)) / (S.mean(axis=0) + 1e-9)


def spectral_centroid(S: np.ndarray) -> np.ndarray:
    """Per-frame magnitude-weighted centroid in Hz (8 kHz Nyquist)."""
    freqs = np.linspace(0, 8000.0, S.shape[0])
    return (freqs[:, None] * S).sum(axis=0) / (S.sum(axis=0) + 1e-9)


def zero_crossing_rate(wav: np.ndarray) -> float:
    if wav.size <= 1:
        return 0.0
    return float(np.mean(np.abs(np.diff(np.signbit(wav).astype(np.int8)))))


def _fit_and_norm(v: np.ndarray, dim: int) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    if v.shape[0] < dim:
        v = np.tile(v, int(np.ceil(dim / v.shape[0])))[:dim]
    else:
        v = v[:dim]
    return (v / (np.linalg.norm(v) + 1e-9)).astype(np.float32)


class MelSpectrogramGenerator:
    """Mel spectrogram in dB (librosa-free)."""

    def __init__(
        self,
        sr: int = 16000,
        n_mels: int = 64,
        n_fft: int = 400,
        hop_length: int = 160,
    ):
        self.sr = sr
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop = hop_length
        self._fb = mel_filterbank(sr, n_fft, n_mels)

    def generate(self, wave, sr: int = 16000, flatten: bool = True) -> np.ndarray:
        wav, _ = ensure_mono_16k(wave, sr)
        S = stft_magnitude(wav, self.n_fft, self.hop) ** 2
        mel = self._fb @ S  # (n_mels, frames)
        db = 10.0 * np.log10(np.maximum(mel, 1e-10))
        db = (db - db.max()).astype(np.float32)  # ref_max dB convention
        return db.flatten() if flatten else db


class SpectralForensics:
    """Fixed-size audio tamper-cue vector (default 128-D)."""

    def __init__(self, dim: int = 128):
        self.dim = int(dim)

    def _spectral_stats(self, wav: np.ndarray) -> np.ndarray:
        """Rich descriptor set (the librosa-ladder equivalent, numpy-only)."""
        S = stft_magnitude(wav)
        feats = [S.mean(), S.std(), S.max(), S.min()]

        n_bins = S.shape[0]
        freqs = np.linspace(0, 8000.0, n_bins)
        power = S.sum(axis=0) + 1e-9

        # spectral contrast proxy: per-octave band peak-to-valley in dB
        bands = np.array_split(np.arange(n_bins), 6)
        contrast = []
        for b in bands:
            sb = np.sort(S[b], axis=0)
            k = max(1, int(0.2 * len(b)))
            valley = sb[:k].mean(axis=0) + 1e-9
            peak = sb[-k:].mean(axis=0) + 1e-9
            contrast.append(np.log(peak / valley))
        contrast = np.stack(contrast)
        feats += [contrast.mean(), contrast.std()]

        # flatness: geometric / arithmetic mean per frame
        flat = spectral_flatness(S)
        feats += [flat.mean(), flat.std()]

        centroid = spectral_centroid(S)
        cum = np.cumsum(S, axis=0) / power[None, :]
        roll_idx = np.argmax(cum >= 0.85, axis=0)
        rolloff = freqs[roll_idx]
        feats += [centroid.mean(), rolloff.mean(), zero_crossing_rate(wav)]

        return _fit_and_norm(np.asarray(feats, dtype=np.float32), self.dim)

    def _stft_stats_fallback(self, wav: np.ndarray) -> np.ndarray:
        S = stft_magnitude(wav)
        feats = np.array([S.mean(), S.std(), S.max(), S.min()], dtype=np.float32)
        return _fit_and_norm(feats, self.dim)

    def extract(self, audio_or_text, sr: int = 16000) -> np.ndarray:
        """Text proxy -> stable hash; waveform -> spectral statistics."""
        if isinstance(audio_or_text, str):
            return hash_embed(audio_or_text, self.dim, max_tokens=self.dim)

        wav, sr = ensure_mono_16k(audio_or_text, sr)
        if wav.size == 0:
            return np.zeros(self.dim, dtype=np.float32)
        try:
            return self._spectral_stats(wav)
        except Exception:
            return self._stft_stats_fallback(wav)

    def extract_text_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Batched text-proxy path for the cache builder."""
        return hash_embed_batch(texts, self.dim, max_tokens=self.dim)

    def extract_waveform_batch(
        self, waves: Sequence[ArrayLike], sr: int = 16000
    ) -> np.ndarray:
        """(B, dim): `extract` of each waveform, after `ensure_mono_16k`."""
        normed = [ensure_mono_16k(w, sr)[0] for w in waves]
        return np.stack([self.extract(w, 16000) for w in normed])


class VoiceCloneDetector:
    """Heuristic voice-tamper likelihood in [0,1]."""

    def score(self, audio_or_text, sr: int = 16000) -> float:
        if isinstance(audio_or_text, str):
            return stable_unit_score(audio_or_text)

        wav, sr = ensure_mono_16k(audio_or_text, sr)
        if wav.size < 2:
            return 0.0
        try:
            S = stft_magnitude(wav)
            flat = float(spectral_flatness(S).mean())
            zcr = zero_crossing_rate(wav)
            cent = float(spectral_centroid(S).mean())
            score = 0.4 * flat + 0.3 * zcr + 0.3 * float(np.tanh(cent / 3000.0))
            return float(np.clip(score, 0.0, 1.0))
        except Exception:
            e = float(np.mean(np.square(wav)))
            return float(np.clip(e / (e + 1.0), 0.0, 1.0))
