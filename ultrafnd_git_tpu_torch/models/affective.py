"""Affective forensics: emotion probes (counterpart of `models/affective.py`).

Host numpy, the same recipe as the JAX analyzer:

    text_intensity = clip(sigmoid(2.5 * (fear + anger - 0.5*joy)))
    intensity      = clip(0.6 * text_intensity + 0.4 * arousal)
    valence        = clip(0.5 + 0.5 * (joy - 0.5*(fear + anger)))

with [fear, anger, joy] from the JAX ladder (`affective.py:88-178`):

  1. the HF emotion classifier (`j-hartmann/emotion-english-distilroberta-
     base`, local files only, through `utils/hf.load_once`): for a RoBERTa
     checkpoint its device twin (`models/roberta.DeviceEmotionClassifier`,
     K2) on the analyzer's device, else the host `transformers` forward;
     its label probabilities summed into the three heads by name buckets;
  2. only when that model does not load, the Chinese sensational-term
     lexicon.

Where the JAX ladder catches a failing twin or host forward and drops
lower, this one raises. Audio arousal comes from an FFT energy and
spectral-centroid proxy.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

from ultrafnd_git_tpu_torch.utils.hf import import_transformers, load_once

EMOTION_MODEL = "j-hartmann/emotion-english-distilroberta-base"

# Chinese sensational-term lexicon
EMO_LEXICON: Dict[str, frozenset] = {
    "fear": frozenset({"恐惧", "警告", "危险", "外星", "消失", "危机", "害怕", "恐怖"}),
    "anger": frozenset({"愤怒", "欺骗", "骗局", "谣言", "假", "讨厌", "生气"}),
    "joy": frozenset({"真相", "辟谣", "科学", "证据", "研究", "发现", "开心", "高兴"}),
}
_HEADS = ("fear", "anger", "joy")
# HF label-name buckets -> the three heads
_LABEL_BUCKETS = {
    "fear": ("fear", "anx", "worr", "scare"),
    "anger": ("anger", "annoy", "mad", "rage"),
    "joy": ("joy", "happi", "delight", "amuse"),
}


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


def load_emotion_model(name: str = EMOTION_MODEL):
    """(tokenizer, model) of a local HF sequence classifier, memoised; None
    without `transformers` or local files."""
    def loader():
        transformers = import_transformers()
        tok = transformers.AutoTokenizer.from_pretrained(name, local_files_only=True)
        model = transformers.AutoModelForSequenceClassification.from_pretrained(
            name, local_files_only=True)
        return tok, model.eval()

    return load_once(f"affective:{name}", loader)


def emotion_rung(name: str = EMOTION_MODEL) -> Optional[str]:
    """"hf:<model>:device" (a RoBERTa checkpoint: the twin) or
    "hf:<model>:host" when the emotion model loads, else None (the
    lexicon), for the cache fingerprint."""
    loaded = load_emotion_model(name)
    if loaded is None:
        return None
    roberta = getattr(loaded[1].config, "model_type", "") == "roberta"
    return f"hf:{name}:" + ("device" if roberta else "host")


def bucket_probs(p: np.ndarray, names: Sequence[str]) -> np.ndarray:
    """(N, C) label probabilities and their names -> (N, 3) fear / anger /
    joy, normalised (the reference's label buckets)."""
    out = np.zeros((p.shape[0], 3), dtype=np.float32)
    for j, head in enumerate(_HEADS):
        cols = [i for i, n in enumerate(names) if any(k in n for k in _LABEL_BUCKETS[head])]
        if cols:
            out[:, j] = p[:, cols].sum(axis=1)
    return out / (out.sum(axis=1, keepdims=True) + 1e-9)


class AffectiveForensics:
    """Batched emotion intensity, arousal and valence."""

    def __init__(self, text_model: str = EMOTION_MODEL, device: str = "cuda"):
        self.text_model_name = text_model
        self.device = device
        self._twin = None

    @classmethod
    def from_config(cls, device: str = "cuda") -> "AffectiveForensics":
        """The analyzer of the shipped `configs/model_configs/affective.yaml`
        (the port reads no YAML; its one field, the HF model, is the default
        here), its twin on `device`."""
        return cls(device=device)

    def text_probs_batch(self, texts: Sequence[str]) -> np.ndarray:
        """(N,) strings -> (N, 3) fear / anger / joy."""
        loaded = load_emotion_model(self.text_model_name)
        if loaded is None:
            return lexicon_probs_batch(texts)
        tok, model = loaded
        if getattr(model.config, "model_type", "") == "roberta":
            if self._twin is None:
                from ultrafnd_git_tpu_torch.models.roberta import DeviceEmotionClassifier

                self._twin = DeviceEmotionClassifier(model, tok, device=self.device)
            return bucket_probs(self._twin.predict_probs(list(texts)), self._twin.label_names)
        import torch

        with torch.inference_mode():
            inp = tok(list(texts), return_tensors="pt", truncation=True, padding=True,
                      max_length=256)
            p = torch.softmax(model(**inp).logits, dim=-1).numpy()
        id2label = getattr(model.config, "id2label", {}) or {}
        return bucket_probs(p, [str(id2label.get(i, i)).lower() for i in range(p.shape[1])])

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
