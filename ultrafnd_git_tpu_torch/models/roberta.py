"""RoBERTa sequence classifier with HuggingFace weights, its attention on K2
(counterpart of `ultrafnd_git_tpu/models/roberta_flax.py`).

The affective scorer's emotion model (`j-hartmann/emotion-english-
distilroberta-base`, a DistilRoBERTa `RobertaForSequenceClassification`).
Its layers are `models/bert.BertLayer` (post-LN, exact GELU, K2 over the
padding bias); the differences live in the embeddings and the head:

  * position ids are the cumulative count of non-pad tokens, offset by the
    pad id (HF `create_position_ids_from_input_ids`): a pad keeps position
    `pad_id`, real tokens count from `pad_id + 1`;
  * one token type; `layer_norm_eps` from the config (1e-5);
  * the head is dense + tanh on the first token (<s>), then `out_proj` to
    the label logits (`RobertaClassificationHead`).

Module names are HF's (`embeddings.*`, `encoder.layer.{i}.*`,
`classifier.dense`, `classifier.out_proj`; the `roberta.` prefix of the
task model's keys is dropped), so its `state_dict()` loads as it is.
`DeviceEmotionClassifier` is the rung on a device: texts -> (N, labels)
softmax probabilities, `label_names` from the config's `id2label`; it
refuses a `model_type` other than "roberta".
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch
from torch import nn

from ultrafnd_git_tpu_torch.models.bert import (
    BertEmbeddings,
    BertLayers,
    hf_config,
    load_hf_weights,
    model_parts,
    pad_to,
    seq_bucket,
    tokenize,
)
from ultrafnd_git_tpu_torch.utils.device import resolve_device, to_device


def label_names(config: Any) -> List[str]:
    """The lower-cased `id2label` names, in label order (a config mapping
    gives the count by its `id2label`, as HF's `num_labels` does)."""
    cfg = hf_config(config)
    id2label = getattr(cfg, "id2label", None) or {}
    count = getattr(cfg, "num_labels", None) or len(id2label)
    return [str(id2label.get(i, i)).lower() for i in range(count)]


class RobertaClassificationHead(nn.Module):
    def __init__(self, width: int, num_labels: int):
        super().__init__()
        self.dense = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, num_labels)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.out_proj(torch.tanh(self.dense(h[:, 0])))


class RobertaClassifier(nn.Module):
    """HF `RobertaForSequenceClassification`: ids, mask -> (B, labels) logits."""

    def __init__(self, width: int = 768, depth: int = 6, heads: int = 12,
                 intermediate: int = 3072, vocab_size: int = 50265, max_positions: int = 514,
                 num_labels: int = 2, pad_id: int = 1, ln_eps: float = 1e-5):
        super().__init__()
        self.pad_id = int(pad_id)
        self.embeddings = BertEmbeddings(vocab_size, width, max_positions, 1, ln_eps)
        self.encoder = BertLayers(depth, width, heads, intermediate, ln_eps)
        self.classifier = RobertaClassificationHead(width, num_labels)

    @classmethod
    def from_config(cls, config: Any) -> "RobertaClassifier":
        cfg = hf_config(config)
        return cls(width=cfg.hidden_size, depth=cfg.num_hidden_layers,
                   heads=cfg.num_attention_heads, intermediate=cfg.intermediate_size,
                   vocab_size=cfg.vocab_size, max_positions=cfg.max_position_embeddings,
                   num_labels=len(label_names(cfg)),
                   pad_id=int(getattr(cfg, "pad_token_id", 1)),
                   ln_eps=float(getattr(cfg, "layer_norm_eps", 1e-5)))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # positions from the token ids (HF: independent of the mask argument)
        nonpad = (ids != self.pad_id).long()
        pos_ids = torch.cumsum(nonpad, dim=1) * nonpad + self.pad_id
        x = self.embeddings(ids, torch.zeros_like(ids), pos_ids)
        return self.classifier(self.encoder(x, mask))


class DeviceEmotionClassifier:
    """HF RoBERTa classifier weights in a `RobertaClassifier` on `device`
    (cuda by default; raises without a GPU): strings -> (N, labels) probs.

    `model` is an HF `RobertaForSequenceClassification`, or its state dict
    with its `config` (an HF config or a mapping of its fields, `id2label`
    and `model_type` among them)."""

    def __init__(self, model: Any, tokenizer: Any, max_length: int = 256,
                 batch_size: int = 256, device: str = "cuda", config: Any = None):
        cfg, sd = model_parts(model, config)
        if getattr(cfg, "model_type", "") != "roberta":
            raise ValueError(f"DeviceEmotionClassifier takes RoBERTa-family checkpoints; got "
                             f"model_type={getattr(cfg, 'model_type', None)!r}")
        self.device = resolve_device(device)
        self.tok = tokenizer
        self.max_length, self.batch_size = int(max_length), int(batch_size)
        self.label_names = label_names(cfg)
        self.module = RobertaClassifier.from_config(cfg)
        load_hf_weights(self.module, sd, "roberta.")
        self.module.to(self.device).eval()

    @torch.inference_mode()
    def _probs(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One chunk, padded to its (batch, sequence) bucket with the pad
        token (so the position count stays right): (n, labels)."""
        n = ids.shape[0]
        sb = seq_bucket(ids.shape[1], self.max_length, smallest=8)
        bb = seq_bucket(n, self.batch_size, smallest=8)
        ids_t = to_device(torch.from_numpy(pad_to(ids, bb, sb, self.module.pad_id)), self.device)
        mask_t = to_device(torch.from_numpy(pad_to(mask, bb, sb)), self.device)
        return torch.softmax(self.module(ids_t, mask_t), dim=-1)[:n].cpu().numpy()

    def predict_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Token ids (N, L) and their 1/0 mask -> (N, labels) probabilities."""
        return self._cat([self._probs(ids[s:s + self.batch_size], mask[s:s + self.batch_size])
                          for s in range(0, len(ids), self.batch_size)])

    def predict_probs(self, texts: Sequence[str]) -> np.ndarray:
        """Strings -> (N, labels) probabilities."""
        return self._cat([
            self._probs(*tokenize(self.tok, [t or "" for t in texts[s:s + self.batch_size]],
                                  self.max_length))
            for s in range(0, len(texts), self.batch_size)])

    def _cat(self, outs: List[np.ndarray]) -> np.ndarray:
        if not outs:
            return np.zeros((0, len(self.label_names)), np.float32)
        return np.concatenate(outs).astype(np.float32)
