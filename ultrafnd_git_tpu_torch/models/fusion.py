"""Cross-modal fusion (counterpart of `models/fusion.py:35-213`).

Training mode (a `torch.Generator` passed as `gen`) drops `dropout` (0.1)
after each GELU of the fuse MLP (`fusion.py:187,192`); the evidence
proxies carry no gradient (`jax.lax.stop_gradient` there, `.detach()`
here). Parameter names are the reference state-dict keys that
`ultrafnd_git_tpu.utils.torch_transfer.fusion_state_dict_from_params`
writes (`fuse_mlp.0` / `.3`, `classifier`, `attn_*.evidence_proj.0` /
`.2`), so that function carries JAX fusion params across unchanged.

On a tensor-parallel mesh (`tp`, set by `parallel/mesh.shard_modules_`)
the fuse MLP runs as a Megatron pair (`models/layers.mlp_pair`).

`dtype=torch.bfloat16` is the JAX module's `dtype=jnp.bfloat16`: every
Dense but the logits head computes in bf16 (`models/layers.py`), and so do
the evidence proxies, the co-attention and the pair features between them;
`fused`, the logits and the forensic scalars come out f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ultrafnd_git_tpu_torch.models.layers import Dense, mlp_pair


def cos01(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine similarity mapped to [0, 1], keepdims. (B,H)x(B,H) -> (B,1)."""
    xn = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
    yn = y / (y.norm(dim=-1, keepdim=True) + 1e-12)
    c = (xn * yn).sum(dim=-1, keepdim=True)
    return 0.5 * (c.clamp(-1.0, 1.0) + 1.0)


class ForensicCoAttention(nn.Module):
    """Evidence-gated co-attention over two modality vectors."""

    def __init__(self, hidden: int, evidence_dim: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden = hidden
        # sqrt(hidden) rounded in the compute dtype, as jnp.sqrt(asarray(H, dtype))
        self.sqrt_hidden = float(torch.tensor(float(hidden), dtype=dtype or torch.float32).sqrt())
        self.q = Dense(hidden, hidden, dtype)
        self.k = Dense(hidden, hidden, dtype)
        self.v = Dense(hidden, hidden, dtype)
        # exact GELU, as the JAX module (the index layout matches the
        # reference's evidence_proj.0 / .2 keys)
        self.evidence_proj = nn.Sequential(
            Dense(evidence_dim, hidden, dtype), nn.GELU(), Dense(hidden, 1, dtype)
        )

    def forward(
        self, x: torch.Tensor, y: torch.Tensor, evidence: torch.Tensor
    ) -> torch.Tensor:
        q, k, v = self.q(x), self.k(y), self.v(y)
        score = (q * k).sum(dim=-1, keepdim=True) / self.sqrt_hidden
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
        dropout: float = 0.1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.use_gnn = use_gnn
        self.dropout = dropout
        self.text_proj = Dense(text_dim, hidden, dtype)
        self.audio_proj = Dense(audio_dim, hidden, dtype)
        self.visual_proj = Dense(visual_dim, hidden, dtype)
        self.temporal_proj = Dense(temporal_dim, hidden, dtype)
        self.attn_tv = ForensicCoAttention(hidden, dtype=dtype)
        self.attn_ta = ForensicCoAttention(hidden, dtype=dtype)
        self.attn_vu = ForensicCoAttention(hidden, dtype=dtype)
        n_parts = 15 + (1 if use_gnn else 0)  # t, a, v, u, 8 pairs, 3 co-attn
        if use_gnn:
            self.gnn_proj = Dense(gnn_dim, hidden, dtype)
        self.fuse_mlp = nn.Sequential(
            Dense(n_parts * hidden, 2 * hidden, dtype),
            nn.GELU(),
            nn.Identity(),  # the reference's dropout slot (see forward)
            Dense(2 * hidden, hidden, dtype),
            nn.GELU(),
        )
        self.classifier = Dense(hidden, 2)  # the logits head stays f32
        self.tp = None  # the model-axis Shard on a tensor-parallel mesh

    def forward(
        self,
        feats: Dict[str, torch.Tensor],
        gen: Optional[torch.Generator] = None,
    ) -> Dict[str, object]:
        """`gen` = None is eval mode; a generator turns dropout on."""
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
            semantic_conflict = (1.0 - cos01(t, v)).detach()  # (B, 1)
            emo_proxy = torch.tanh(t.abs().mean(dim=-1, keepdim=True)).detach()
            delay_proxy = (1.0 - cos01(t, u)).detach()
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
        mlp = self.fuse_mlp
        fused = mlp_pair(mlp[0], mlp[3], torch.cat(parts, dim=-1), self.dropout, gen,
                         self.tp).float()
        return {
            "fused": fused,
            "logits": self.classifier(fused),
            "forensic": {
                "emotion_intensity": emo_proxy.squeeze(-1).float(),
                "semantic_conflict": semantic_conflict.squeeze(-1).float(),
                "temporal_delay": delay_proxy.squeeze(-1).float(),
            },
        }
