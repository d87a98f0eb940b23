"""The feature cache's text, audio and visual encoders, counterparts of
the JAX encoders' ladders:

* text: `BERTContextEncoder`'s ladder (`models/text.py:45-280`), in JAX's
  order (`text.py:209-232`):
  1. the trained tower of `ULTRAFND_TEXT_DEVICE_CKPT` (under
     `ULTRAFND_TEXT_DEVICE=1`);
  2. HF BERT (`bert-base-uncased`, local files only, through
     `utils/hf.load_once`): the device twin (`models/bert.DeviceBertEncoder`,
     K2) on the encoder's device, or the host `transformers` forward under
     `ULTRAFND_BERT_DEVICE=0` or for a checkpoint whose `model_type` is not
     "bert" (`text.py:141-160`);
  3. the seeded tower (`models/transformer.DeviceTextEncoder` on the
     encoder's device: 768 wide, 12 heads of 64, depth 4, S = 256), under
     `ULTRAFND_TEXT_DEVICE=1`;
  4. the stable-hash bag-of-words embedding.
  Where the JAX ladder catches a failing HF rung and drops to the tower
  (`text.py:225-228`), this one raises.
* the text-proxy paths of `SpectralForensics` (`models/audio.py:288`),
  `OpticalFlow3DCNN` and `DeepForgeryDetector` (`models/visual.py:213`,
  `:298`), each the stable-hash embedding at its width.

`ULTRAFND_TEXT_DEVICE` and `ULTRAFND_BERT_DEVICE` are read when a
`TextFieldEncoder` is built, `ULTRAFND_TEXT_DEVICE_CKPT` when its tower is
first used, as the JAX encoder reads them; the CKPT variable does nothing
without the first. A trained tower that fails to load raises: the caller
asked for trained weights. `text_rung()` names the rung the environment
selects, for the cache fingerprint.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ultrafnd_git_tpu_torch.ops.hashing import hash_embed_batch
from ultrafnd_git_tpu_torch.utils.hf import import_transformers, load_once

TEXT_DEVICE = "ULTRAFND_TEXT_DEVICE"
TEXT_DEVICE_CKPT = "ULTRAFND_TEXT_DEVICE_CKPT"
BERT_DEVICE = "ULTRAFND_BERT_DEVICE"
BERT_MODEL = "bert-base-uncased"
HOST_BATCH = 64  # strings a host `transformers` forward (the JAX ladder's hf_batch_size)


def _wants_tower(use_device_tower: Optional[bool] = None) -> bool:
    if use_device_tower is None:
        return os.environ.get(TEXT_DEVICE, "0") == "1"
    return bool(use_device_tower)


def load_bert(model_name: str = BERT_MODEL):
    """(tokenizer, model) of a local HF checkpoint, memoised; None without
    `transformers` or local files."""
    def loader():
        transformers = import_transformers()
        tok = transformers.AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        model = transformers.AutoModel.from_pretrained(model_name, local_files_only=True)
        return tok, model.eval()

    return load_once(f"text:{model_name}", loader)


def bert_on_device(model) -> bool:
    """The HF rung's choice: the device twin, or the host forward."""
    return (os.environ.get(BERT_DEVICE, "1") == "1"
            and getattr(model.config, "model_type", "") == "bert")


def text_rung(model_name: str = BERT_MODEL) -> Optional[str]:
    """The text rung the environment selects, in the ladder's order: the
    trained tower's `tower_rung()`, "hf:<model>:device" or "hf:<model>:host"
    when the HF rung loads, "tower-seeded", or None for the hash rung."""
    if _wants_tower() and os.environ.get(TEXT_DEVICE_CKPT):
        return tower_rung()
    loaded = load_bert(model_name)
    if loaded is not None:
        return f"hf:{model_name}:" + ("device" if bert_on_device(loaded[1]) else "host")
    return tower_rung()


def tower_rung() -> Optional[str]:
    """The tower rung the environment selects (the HF rung aside): None,
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
                 use_device_tower: Optional[bool] = None, device: str = "cuda",
                 model_name: str = BERT_MODEL):
        self.dim = int(dim)
        self.max_length = int(max_length)
        self.device = device
        self._want_device_tower = _wants_tower(use_device_tower)
        self._device_tower = None
        loaded = load_bert(model_name)
        self.use_hf = loaded is not None
        self.tok, self.model = loaded if loaded is not None else (None, None)
        self._bert_on_device = self.use_hf and bert_on_device(self.model)
        self._device_bert = None

    def _hf_encode_batch(self, texts: List[str]) -> np.ndarray:
        """The HF rung: the device twin (built at first use), or the host
        forward; (N, dim) mean-pooled under the mask, fit, L2-normalised."""
        if self._bert_on_device:
            if self._device_bert is None:
                from ultrafnd_git_tpu_torch.models.bert import DeviceBertEncoder

                self._device_bert = DeviceBertEncoder(self.model, self.tok, dim=self.dim,
                                                      max_length=self.max_length,
                                                      device=self.device)
            return self._device_bert.encode_batch(texts)
        import torch

        from ultrafnd_git_tpu_torch.models.bert import fit_dim, l2_rows

        outs = []
        with torch.inference_mode():
            for s in range(0, len(texts), HOST_BATCH):
                enc = self.tok(texts[s:s + HOST_BATCH], return_tensors="pt",
                               padding=True, truncation=True, max_length=self.max_length)
                hidden = self.model(**enc).last_hidden_state
                m = enc["attention_mask"].unsqueeze(-1).float()
                outs.append(((hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)).numpy())
        return l2_rows(fit_dim(np.concatenate(outs, axis=0), self.dim))

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
        """(N, dim) f32 from the first rung of the ladder that applies;
        empty strings map to zero rows."""
        texts = list(texts)
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        if self._want_device_tower and os.environ.get(TEXT_DEVICE_CKPT):
            return self._encode_nonempty(texts, self._tower().encode_batch)
        if self.use_hf:
            return self._encode_nonempty(texts, self._hf_encode_batch)
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
