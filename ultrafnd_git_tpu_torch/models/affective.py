"""Affective forensics: emotion probes (counterpart of `models/affective.py`).

Host numpy, the same recipe as the JAX analyzer:

    text_intensity = clip(sigmoid(2.5 * (fear + anger - 0.5*joy)))
    intensity      = clip(0.6 * text_intensity + 0.4 * arousal)
    valence        = clip(0.5 + 0.5 * (joy - 0.5*(fear + anger)))

with [fear, anger, joy] from the Chinese sensational-term lexicon, the rung
the JAX ladder falls to without HuggingFace weights (its HF emotion
classifier rungs are not ported; see ROADMAP.md), and audio arousal from an
FFT energy and spectral-centroid proxy.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

# Chinese sensational-term lexicon
EMO_LEXICON: Dict[str, frozenset] = {
    "fear": frozenset({"恐惧", "警告", "危险", "外星", "消失", "危机", "害怕", "恐怖"}),
    "anger": frozenset({"愤怒", "欺骗", "骗局", "谣言", "假", "讨厌", "生气"}),
    "joy": frozenset({"真相", "辟谣", "科学", "证据", "研究", "发现", "开心", "高兴"}),
}
_HEADS = ("fear", "anger", "joy")


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def lexicon_probs_batch(texts: Sequence[str]) -> np.ndarray:
    """(N,) strings -> (N, 3) [fear, anger, joy], rows sum to <= 1."""
    counts = np.zeros((len(texts), 3), dtype=np.float32)
    for i, text in enumerate(texts):
        if not text:
            continue
        for j, head in enumerate(_HEADS):
            counts[i, j] = sum(1.0 for w in EMO_LEXICON[head] if w in text)
    totals = counts.sum(axis=1, keepdims=True) + 1e-9
    return counts / totals


class AffectiveForensics:
    """Batched emotion intensity, arousal and valence."""

    @classmethod
    def from_config(cls) -> "AffectiveForensics":
        """The analyzer of the shipped `configs/model_configs/affective.yaml`,
        whose one field names the HF rung's model (not ported)."""
        return cls()

    def text_probs_batch(self, texts: Sequence[str]) -> np.ndarray:
        """(N,) strings -> (N, 3) fear / anger / joy (the lexicon rung)."""
        return lexicon_probs_batch(texts)

    @staticmethod
    def audio_arousal(audio: Optional[np.ndarray], sr: int = 16000) -> float:
        if audio is None:
            return 0.5
        wave = np.asarray(audio, dtype=np.float32).ravel()
        if wave.size == 0:
            return 0.5
        energy = float(np.mean(wave**2))
        # pitch proxy: magnitude-weighted spectral centroid in Hz over the
        # first 10 s; with it the pitch-spread term of the formula is 0
        spec = np.abs(np.fft.rfft(wave[: min(wave.size, sr * 10)]))
        freqs = np.fft.rfftfreq(min(wave.size, sr * 10), d=1.0 / sr)
        centroid = float((spec * freqs).sum() / (spec.sum() + 1e-9))
        pit_std = 0.0
        a = _sigmoid(
            np.tanh(5.0 * energy) + np.tanh(centroid / 300.0) - 0.5 * np.tanh(pit_std / 50.0)
        )
        return float(np.clip(a, 0.0, 1.0))

    def analyze_batch(
        self,
        texts: Sequence[str],
        audios: Optional[Sequence[Optional[np.ndarray]]] = None,
        sr: int = 16000,
    ) -> Dict[str, np.ndarray]:
        """Corpus-wide analysis: probs (N, 3), intensity, arousal, valence (N,)."""
        probs = self.text_probs_batch(texts)
        fear, anger, joy = probs[:, 0], probs[:, 1], probs[:, 2]
        text_intensity = np.clip(_sigmoid(2.5 * (fear + anger - 0.5 * joy)), 0.0, 1.0)
        if audios is None:
            arousal = np.full(len(texts), 0.5, dtype=np.float32)
        else:
            arousal = np.array([self.audio_arousal(a, sr) for a in audios], dtype=np.float32)
        intensity = np.clip(0.6 * text_intensity + 0.4 * arousal, 0.0, 1.0)
        valence = np.clip(0.5 + 0.5 * (joy - 0.5 * (fear + anger)), 0.0, 1.0)
        return {
            "probs": probs,
            "intensity": intensity.astype(np.float32),
            "arousal": arousal.astype(np.float32),
            "valence": valence.astype(np.float32),
        }

    def analyze(
        self, text: Optional[str] = None, audio: Optional[np.ndarray] = None, sr: int = 16000
    ) -> Dict[str, Union[float, Dict[str, float]]]:
        """One sample: {probs: {fear, anger, joy}, intensity, arousal, valence}."""
        out = self.analyze_batch([text or ""], None if audio is None else [audio], sr=sr)
        probs = out["probs"][0]
        return {
            "probs": {h: float(probs[i]) for i, h in enumerate(_HEADS)},
            "intensity": float(out["intensity"][0]),
            "arousal": float(out["arousal"][0]),
            "valence": float(out["valence"][0]),
        }

    def get_emotion_intensity(
        self, text: Optional[str] = None, audio: Optional[np.ndarray] = None, sr: int = 16000
    ) -> float:
        return float(self.analyze(text=text, audio=audio, sr=sr)["intensity"])
