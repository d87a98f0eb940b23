"""The feature cache's text, audio and visual encoders, hash rungs only.

Counterparts of the rungs the JAX encoders fall to without HuggingFace
weights (their HF and media rungs are not ported; see ROADMAP.md):
`BERTContextEncoder.encode_fields_batch` (`models/text.py:248-280`), and
the text-proxy paths of `SpectralForensics` (`models/audio.py:288`),
`OpticalFlow3DCNN` and `DeepForgeryDetector` (`models/visual.py:213`,
`:298`), each the stable-hash bag-of-words embedding at its width.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ultrafnd_git_tpu_torch.ops.hashing import hash_embed_batch


class TextFieldEncoder:
    """Mean of the hash embeddings of title, OCR and up to 10 comments,
    L2-normalised; a record with no text stays zero."""

    def __init__(self, dim: int = 768):
        self.dim = int(dim)

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
        vecs = hash_embed_batch(flat, self.dim)
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
