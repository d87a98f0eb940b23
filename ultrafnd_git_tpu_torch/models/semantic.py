"""Semantic forgery analysis (counterpart of `models/semantic.py`).

`SemanticForgeryAnalyzer.gap_magnitude(titles, ocrs)` is what the feature
cache reads: half the L2 distance between the L2-normalised encoder
features of title and OCR, in [0, 1]. The encoder is the JAX ladder
(`semantic.py:135-205`): CLIP's text tower (`openai/clip-vit-base-patch32`,
local files only, through `utils/hf.load_once`) when it loads, as its
device twin (`models/clip.DeviceClipTextEncoder`) on the analyzer's device,
or the host `transformers` forward (`get_text_features`, L2-normalised)
under `ULTRAFND_CLIP_DEVICE=0` (read at the first encode); without it, the
stable-hash embedding at width 512 (`zeros_fallback=True` gives the
reference's all-zero features instead). Where the JAX ladder catches a
failing CLIP rung and drops to the hash rung, this one raises.

`SemanticProjector` is the JAX module's two projection branches (Linear ->
exact GELU -> dropout, 512 -> proj_dim each) and its three normalised
outputs. No v2 path applies it; `utils/transfer.semantic_projector_state_dict`
carries JAX params into it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.models.dropout import dropout as drop
from ultrafnd_git_tpu_torch.ops.hashing import hash_embed_batch
from ultrafnd_git_tpu_torch.utils.hf import import_transformers, load_once

ENCODER_DIM = 512  # CLIP ViT-B/32 text features, and the hash rung's width
CLIP_DEVICE = "ULTRAFND_CLIP_DEVICE"


def l2n(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return x / (x.norm(dim=-1, keepdim=True) + eps)


@dataclass
class SemanticConfig:
    model_name: str = "openai/clip-vit-base-patch32"
    proj_dim: int = 512
    dropout: float = 0.3
    max_length: int = 64
    zeros_fallback: bool = False  # the reference's all-zero offline features


class SemanticProjector(nn.Module):
    """Two projection branches and the directional gap."""

    def __init__(self, in_dim: int = ENCODER_DIM, proj_dim: int = 512, dropout: float = 0.3):
        super().__init__()
        self.dropout = dropout
        self.text_dense = nn.Linear(in_dim, proj_dim)
        self.vision_dense = nn.Linear(in_dim, proj_dim)

    def forward(
        self, text_feat: torch.Tensor, image_feat: torch.Tensor,
        gen: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """`gen` = None is eval mode; a generator turns dropout on."""
        txt = drop(F.gelu(self.text_dense(text_feat)), self.dropout, gen)
        img = drop(F.gelu(self.vision_dense(image_feat)), self.dropout, gen)
        return {
            "semantic_text": l2n(txt),
            "semantic_image": l2n(img),
            "semantic_gap": l2n(txt - img),
        }


def load_clip(name: str):
    """(tokenizer, CLIPModel) of a local HF checkpoint, memoised; None
    without `transformers` or local files."""
    def loader():
        transformers = import_transformers()
        tok = transformers.AutoTokenizer.from_pretrained(name, local_files_only=True)
        model = transformers.CLIPModel.from_pretrained(name, local_files_only=True)
        return tok, model.eval()

    return load_once(f"clip:{name}", loader)


def clip_rung(name: str = SemanticConfig.model_name) -> Optional[str]:
    """"hf:<model>:device" or "hf:<model>:host" when the CLIP rung loads,
    else None (the hash rung), for the cache fingerprint."""
    if load_clip(name) is None:
        return None
    return f"hf:{name}:" + ("device" if os.environ.get(CLIP_DEVICE, "1") == "1" else "host")


class SemanticForgeryAnalyzer:
    """Title-vs-OCR semantic consistency on the CLIP text tower or the hash
    encoder."""

    def __init__(self, cfg: Optional[SemanticConfig] = None, device: str = "cuda"):
        self.cfg = cfg or SemanticConfig()
        self.device = device
        self._twin = None
        self._on_device: Optional[bool] = None  # ULTRAFND_CLIP_DEVICE, read at first use

    @classmethod
    def from_config(cls, device: str = "cuda") -> "SemanticForgeryAnalyzer":
        """The shipped `configs/model_configs/semantic.yaml` (the port reads
        no YAML; its fields equal the defaults here), its twin on `device`."""
        return cls(SemanticConfig(), device=device)

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        """Strings -> (B, 512) L2-normalised features."""
        texts = [t or "" for t in texts]
        clip = load_clip(self.cfg.model_name)
        if clip is not None:
            tok, model = clip
            if self._on_device is None:
                self._on_device = os.environ.get(CLIP_DEVICE, "1") == "1"
            if self._on_device:
                if self._twin is None:
                    from ultrafnd_git_tpu_torch.models.clip import DeviceClipTextEncoder

                    self._twin = DeviceClipTextEncoder(model, tok, max_length=self.cfg.max_length,
                                                       device=self.device)
                return self._twin.encode_batch(texts)
            with torch.inference_mode():
                toks = tok(texts, padding=True, truncation=True,
                           max_length=self.cfg.max_length, return_tensors="pt")
                feats = model.get_text_features(**toks).numpy()
            return (feats / (np.linalg.norm(feats, axis=-1, keepdims=True) + 1e-9)).astype(
                np.float32)
        if self.cfg.zeros_fallback:
            return np.zeros((len(texts), ENCODER_DIM), dtype=np.float32)
        return hash_embed_batch(texts, ENCODER_DIM, max_tokens=ENCODER_DIM)

    def encode_image_like(self, texts: Sequence[str]) -> np.ndarray:
        """Pseudo-vision features from OCR / title strings."""
        return self.encode_text(texts)

    def gap_magnitude(self, titles: Sequence[str], ocrs: Sequence[str]) -> np.ndarray:
        """(B,) semantic discrepancy in [0, 1]: half the L2 distance of the
        encoder features of title and OCR (identical inputs -> 0)."""
        b = max(len(titles), len(ocrs))
        titles = list(titles) + [""] * (b - len(titles))
        ocrs = list(ocrs) + [""] * (b - len(ocrs))
        d = np.linalg.norm(self.encode_text(titles) - self.encode_image_like(ocrs), axis=-1)
        return np.clip(0.5 * d, 0.0, 1.0).astype(np.float32)
