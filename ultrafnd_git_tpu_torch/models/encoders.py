"""The feature cache's text, audio and visual encoders.

Counterparts of the rungs the JAX encoders take without HuggingFace
weights (their HF and media rungs are not ported; see ROADMAP.md):

* text: `BERTContextEncoder`'s ladder without its HF rung
  (`models/text.py:45-280`): the trained tower of
  `ULTRAFND_TEXT_DEVICE_CKPT`, then the seeded tower, both only under
  `ULTRAFND_TEXT_DEVICE=1` (`models/transformer.DeviceTextEncoder` on the
  encoder's device: 768 wide, 12 heads of 64, depth 4, S = 256 seeded),
  then the stable-hash bag-of-words embedding;
* the text-proxy paths of `SpectralForensics` (`models/audio.py:288`),
  `OpticalFlow3DCNN` and `DeepForgeryDetector` (`models/visual.py:213`,
  `:298`), each the stable-hash embedding at its width.

`ULTRAFND_TEXT_DEVICE` is read when a `TextFieldEncoder` is built,
`ULTRAFND_TEXT_DEVICE_CKPT` when its tower is first used, as the JAX
encoder reads them; the CKPT variable does nothing without the other. A
trained tower that fails to load raises: the caller asked for trained
weights. `tower_rung()` names the rung the environment selects, for the
cache fingerprint.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ultrafnd_git_tpu_torch.ops.hashing import hash_embed_batch

TEXT_DEVICE = "ULTRAFND_TEXT_DEVICE"
TEXT_DEVICE_CKPT = "ULTRAFND_TEXT_DEVICE_CKPT"


def _wants_tower(use_device_tower: Optional[bool] = None) -> bool:
    if use_device_tower is None:
        return os.environ.get(TEXT_DEVICE, "0") == "1"
    return bool(use_device_tower)


def tower_rung() -> Optional[str]:
    """The text rung the environment selects: None for the hash rung,
    "tower-seeded", or "tower:<resolved path>/<slot>" of the trained tower
    (`<resolved path>` alone for an exported model directory)."""
    if not _wants_tower():
        return None
    ckpt = os.environ.get(TEXT_DEVICE_CKPT)
    if not ckpt:
        return "tower-seeded"
    from ultrafnd_git_tpu_torch.models.transformer import checkpoint_identity

    return "tower:" + checkpoint_identity(ckpt)


class TextFieldEncoder:
    """Mean of the encodings of title, OCR and up to 10 comments,
    L2-normalised; a record with no text stays zero, and so does an empty
    string."""

    def __init__(self, dim: int = 768, max_length: int = 256,
                 use_device_tower: Optional[bool] = None, device: str = "cuda"):
        self.dim = int(dim)
        self.max_length = int(max_length)
        self.device = device
        self._want_device_tower = _wants_tower(use_device_tower)
        self._device_tower = None

    def _tower(self):
        """The tower rung, built at first use; None on the hash rung."""
        if self._device_tower is None and self._want_device_tower:
            from ultrafnd_git_tpu_torch.models.transformer import DeviceTextEncoder

            ckpt = os.environ.get(TEXT_DEVICE_CKPT)
            if ckpt:
                self._device_tower = DeviceTextEncoder.from_checkpoint(ckpt, device=self.device)
            else:
                self._device_tower = DeviceTextEncoder(
                    dim=self.dim, heads=max(1, self.dim // 64), max_len=self.max_length,
                    seed=0, device=self.device)
        return self._device_tower

    def encode(self, text: Optional[str]) -> np.ndarray:
        return self.encode_batch([text or ""])[0]

    def _encode_nonempty(self, texts: List[str], row_encoder) -> np.ndarray:
        """`row_encoder` over the non-empty strings, zero rows elsewhere."""
        nonempty = [i for i, t in enumerate(texts) if t]
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        if nonempty:
            out[nonempty] = row_encoder([texts[i] for i in nonempty])
        return out

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """(N, dim) f32: the tower's rows under the tower rung, else the hash
        embeddings; empty strings map to zero rows."""
        texts = list(texts)
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        tower = self._tower()
        if tower is not None:
            return self._encode_nonempty(texts, tower.encode_batch)
        return hash_embed_batch(texts, self.dim)

    def encode_fields_batch(self, records: Sequence[Dict]) -> np.ndarray:
        flat: List[str] = []
        owners: List[int] = []
        for i, rec in enumerate(records):
            parts = [t for t in [rec.get("title"), rec.get("ocr"),
                                 *(rec.get("comments") or [])[:10]] if t]
            flat.extend(parts)
            owners.extend([i] * len(parts))
        n = len(records)
        out = np.zeros((n, self.dim), dtype=np.float32)
        if not flat:
            return out
        vecs = self.encode_batch(flat)
        counts = np.zeros((n, 1), dtype=np.float32)
        np.add.at(out, np.asarray(owners), vecs)
        np.add.at(counts, (np.asarray(owners), np.zeros(len(owners), int)), 1.0)
        np.divide(out, counts, out=out, where=counts > 0)
        norms = np.linalg.norm(out, axis=-1, keepdims=True)
        np.divide(out, norms + 1e-9, out=out, where=norms > 0)
        return out.astype(np.float32)


class ProxyTextEncoder:
    """A text proxy's hash embedding at `dim`, at most `dim` tokens: the
    audio encoder's `extract_text_batch` and the visual flow and ELA
    encoders' (`ela_lbp_text_batch`)."""

    def __init__(self, dim: int):
        self.dim = int(dim)

    def extract_text_batch(self, texts: Sequence[str]) -> np.ndarray:
        return hash_embed_batch(texts, self.dim, max_tokens=self.dim)

    ela_lbp_text_batch = extract_text_batch
