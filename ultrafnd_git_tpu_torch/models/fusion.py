"""Cross-modal fusion (counterpart of `models/fusion.py:35-213`), eval mode.

Parameter names are the reference state-dict keys that
`ultrafnd_git_tpu.utils.torch_transfer.fusion_state_dict_from_params`
writes (`fuse_mlp.0` / `.3`, `classifier`, `attn_*.evidence_proj.0` /
`.2`), so that function carries JAX fusion params across unchanged.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


def cos01(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine similarity mapped to [0, 1], keepdims. (B,H)x(B,H) -> (B,1)."""
    xn = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
    yn = y / (y.norm(dim=-1, keepdim=True) + 1e-12)
    c = (xn * yn).sum(dim=-1, keepdim=True)
    return 0.5 * (c.clamp(-1.0, 1.0) + 1.0)


class ForensicCoAttention(nn.Module):
    """Evidence-gated co-attention over two modality vectors."""

    def __init__(self, hidden: int, evidence_dim: int = 3):
        super().__init__()
        self.hidden = hidden
        self.q = nn.Linear(hidden, hidden)
        self.k = nn.Linear(hidden, hidden)
        self.v = nn.Linear(hidden, hidden)
        # exact GELU, as the JAX module (the index layout matches the
        # reference's evidence_proj.0 / .2 keys)
        self.evidence_proj = nn.Sequential(
            nn.Linear(evidence_dim, hidden), nn.GELU(), nn.Linear(hidden, 1)
        )

    def forward(
        self, x: torch.Tensor, y: torch.Tensor, evidence: torch.Tensor
    ) -> torch.Tensor:
        q, k, v = self.q(x), self.k(y), self.v(y)
        score = (q * k).sum(dim=-1, keepdim=True) / math.sqrt(self.hidden)
        attn = torch.sigmoid(score)  # (B, 1)
        gate = torch.sigmoid(self.evidence_proj(evidence))  # (B, 1)
        return gate * (attn * v) + (1.0 - gate) * 0.5 * (x + y)


class CrossModalTransformer(nn.Module):
    """Fuse text/audio/visual/temporal (+ optional GNN) feature vectors."""

    def __init__(
        self,
        hidden: int = 512,
        text_dim: int = 768,
        audio_dim: int = 128,
        visual_dim: int = 512,
        temporal_dim: int = 256,
        use_gnn: bool = True,
        gnn_dim: int = 128,
    ):
        super().__init__()
        self.use_gnn = use_gnn
        self.text_proj = nn.Linear(text_dim, hidden)
        self.audio_proj = nn.Linear(audio_dim, hidden)
        self.visual_proj = nn.Linear(visual_dim, hidden)
        self.temporal_proj = nn.Linear(temporal_dim, hidden)
        self.attn_tv = ForensicCoAttention(hidden)
        self.attn_ta = ForensicCoAttention(hidden)
        self.attn_vu = ForensicCoAttention(hidden)
        n_parts = 15 + (1 if use_gnn else 0)  # t, a, v, u, 8 pairs, 3 co-attn
        if use_gnn:
            self.gnn_proj = nn.Linear(gnn_dim, hidden)
        self.fuse_mlp = nn.Sequential(
            nn.Linear(n_parts * hidden, 2 * hidden),
            nn.GELU(),
            nn.Identity(),  # the reference's dropout slot (eval: identity)
            nn.Linear(2 * hidden, hidden),
            nn.GELU(),
        )
        self.classifier = nn.Linear(hidden, 2)

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, object]:
        t = self.text_proj(feats["text_features"])
        a = self.audio_proj(feats["audio_features"])
        v = self.visual_proj(feats["visual_features"])
        u = self.temporal_proj(feats["temporal_features"])

        evidence = feats.get("evidence")
        if evidence is not None:
            semantic_conflict = evidence[:, 0:1]
            emo_proxy = evidence[:, 1:2]
            delay_proxy = evidence[:, 2:3]
        else:
            semantic_conflict = 1.0 - cos01(t, v)  # (B, 1)
            emo_proxy = torch.tanh(t.abs().mean(dim=-1, keepdim=True))
            delay_proxy = 1.0 - cos01(t, u)
        zeros = torch.zeros_like(emo_proxy)

        tv_star = self.attn_tv(
            t, v, torch.cat([semantic_conflict, emo_proxy, zeros], -1)
        )
        ta_star = self.attn_ta(t, a, torch.cat([emo_proxy, zeros, zeros], -1))
        vu_star = self.attn_vu(
            v, u, torch.cat([delay_proxy, zeros, zeros], -1)
        )
        pairs = torch.cat(
            [
                t + a, t * a, (t - a).abs(),
                t + v, t * v, (t - v).abs(),
                t + u, v + u,
            ],
            dim=-1,
        )  # (B, 8H)
        parts = [t, a, v, u, pairs, tv_star, ta_star, vu_star]
        if self.use_gnn:
            parts.append(self.gnn_proj(feats["gnn_feat"]))
        fused = self.fuse_mlp(torch.cat(parts, dim=-1))
        return {
            "fused": fused,
            "logits": self.classifier(fused),
            "forensic": {
                "emotion_intensity": emo_proxy.squeeze(-1),
                "semantic_conflict": semantic_conflict.squeeze(-1),
                "temporal_delay": delay_proxy.squeeze(-1),
            },
        }
