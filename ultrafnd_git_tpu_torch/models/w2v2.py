"""wav2vec2 (BASE layout) with HuggingFace weights, its attention on K2
(counterpart of `ultrafnd_git_tpu/models/w2v2_flax.py`).

`Wav2Vec2Encoder` is HF's `Wav2Vec2Model` with `do_stable_layer_norm=False`
(`facebook/wav2vec2-base-960h`): the conv feature extractor (strided 1-D
convs without bias; GroupNorm with a group a channel on the first; exact
GELU), the feature projection (LayerNorm, Linear), the weight-normed
positional conv (kernel 128, 16 groups, padded 64 a side and its last
frame dropped for the even kernel; exact GELU) added to it, the encoder
LayerNorm, then post-LN layers whose attention is K2 over all frames
(`_default_bias` gives the zero bias: the waveforms of a batch have one
length). Module names are HF's; `load_w2v2_weights` takes a `Wav2Vec2Model`
or `Wav2Vec2ForCTC` state dict (`wav2vec2.` prefix dropped) and
materialises the positional conv's weight from either
`parametrizations.weight.original0/1` or `weight_g` / `weight_v`:
weight[:, :, p] = g[:, :, p] v[:, :, p] / ||v[:, :, p]||, in float64.

`DeviceW2V2Encoder` is the audio ladder's rung on a device
(`w2v2_flax.py:250-364`): equal-length 16 kHz waveforms, each row
normalised to zero mean and unit variance (+1e-7, the HF processor's
`do_normalize`), the last hidden state mean-pooled over time and projected
to `dim` by the host rung's seeded head (`torch.Generator().manual_seed(0)`,
randn(dim, hidden) / sqrt(hidden)), in chunks padded to a power-of-two
batch. `unsupported(config, processor)` names what this tower does not
implement (the stable-LN layout, an activation other than "gelu", a
processor with `do_normalize=False`); the ladder asks it before it builds
the twin and keeps the host forward for such a checkpoint, and the twin
refuses one.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.models.bert import (
    Attention,
    heads_first,
    heads_last,
    hf_config,
    load_hf_weights,
    model_parts,
    seq_bucket,
)
from ultrafnd_git_tpu_torch.utils.device import resolve_device, to_device

POS_CONV = "encoder.pos_conv_embed.conv"


def unsupported(config: Any, processor: Any = None) -> Optional[str]:
    """Why the device tower cannot run this checkpoint (None if it can)."""
    cfg = hf_config(config)
    if processor is not None and not bool(getattr(
            getattr(processor, "feature_extractor", processor), "do_normalize", True)):
        return "the processor has do_normalize=False; the tower always normalises"
    if bool(getattr(cfg, "do_stable_layer_norm", False)):
        return "do_stable_layer_norm=True (the LARGE layout); the tower is the BASE layout"
    for field in ("hidden_act", "feat_extract_activation"):
        act = str(getattr(cfg, field, "gelu"))
        if act != "gelu":
            return f"{field}={act!r}, not the exact GELU the tower implements"
    return None


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, bias: bool,
                 group_norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=bias)
        # HF names the first layer's GroupNorm `layer_norm`
        self.layer_norm = nn.GroupNorm(c_out, c_out, eps=1e-5) if group_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    """(B, T) waveform -> (B, C, T')."""

    def __init__(self, conv_dim, conv_kernel, conv_stride, conv_bias: bool):
        super().__init__()
        dims = (1, *conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, conv_bias, group_norm=i == 0)
            for i, (k, s) in enumerate(zip(conv_kernel, conv_stride)))

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        x = wave[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, c: int, width: int, eps: float):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c, eps=eps)
        self.projection = nn.Linear(c, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class PositionalConv(nn.Module):
    def __init__(self, width: int, kernel: int, groups: int):
        super().__init__()
        self.conv = nn.Conv1d(width, width, kernel, padding=kernel // 2, groups=groups)
        self.trim = kernel % 2 == 0  # HF's Wav2Vec2SamePadLayer

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        pos = self.conv(h.transpose(1, 2))
        if self.trim:
            pos = pos[..., :-1]
        return F.gelu(pos).transpose(1, 2)


class W2V2SelfAttention(Attention):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (heads_first(p(x), self.heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(heads_last(self.attend(q, k, v, None)))


class _FeedForward(nn.Module):
    def __init__(self, width: int, intermediate: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(width, intermediate)
        self.output_dense = nn.Linear(intermediate, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class W2V2Layer(nn.Module):
    """Post-LN layer (BASE): LayerNorm after each residual add."""

    def __init__(self, width: int, heads: int, intermediate: int, eps: float):
        super().__init__()
        self.attention = W2V2SelfAttention(width, heads)
        self.layer_norm = nn.LayerNorm(width, eps=eps)
        self.feed_forward = _FeedForward(width, intermediate)
        self.final_layer_norm = nn.LayerNorm(width, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class W2V2Transformer(nn.Module):
    """HF's `encoder`: positional conv, LayerNorm, `layers.{i}`."""

    def __init__(self, depth: int, width: int, heads: int, intermediate: int,
                 pos_kernel: int, pos_groups: int, eps: float):
        super().__init__()
        self.pos_conv_embed = PositionalConv(width, pos_kernel, pos_groups)
        self.layer_norm = nn.LayerNorm(width, eps=eps)
        self.layers = nn.ModuleList(W2V2Layer(width, heads, intermediate, eps)
                                    for _ in range(depth))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm(h + self.pos_conv_embed(h))
        for layer in self.layers:
            h = layer(h)
        return h


class Wav2Vec2Encoder(nn.Module):
    """HF `Wav2Vec2Model` (BASE): (B, T) waveform -> (B, T', width)."""

    def __init__(self, width: int = 768, depth: int = 12, heads: int = 12,
                 intermediate: int = 3072, conv_dim=(512,) * 7,
                 conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
                 conv_bias: bool = False, pos_conv_kernel: int = 128, pos_conv_groups: int = 16,
                 ln_eps: float = 1e-5):
        super().__init__()
        self.feature_extractor = FeatureExtractor(conv_dim, conv_kernel, conv_stride, conv_bias)
        self.feature_projection = FeatureProjection(conv_dim[-1], width, ln_eps)
        self.encoder = W2V2Transformer(depth, width, heads, intermediate, pos_conv_kernel,
                                       pos_conv_groups, ln_eps)

    @classmethod
    def from_config(cls, config: Any) -> "Wav2Vec2Encoder":
        cfg = hf_config(config)
        return cls(width=cfg.hidden_size, depth=cfg.num_hidden_layers,
                   heads=cfg.num_attention_heads, intermediate=cfg.intermediate_size,
                   conv_dim=tuple(cfg.conv_dim), conv_kernel=tuple(cfg.conv_kernel),
                   conv_stride=tuple(cfg.conv_stride), conv_bias=bool(cfg.conv_bias),
                   pos_conv_kernel=int(cfg.num_conv_pos_embeddings),
                   pos_conv_groups=int(cfg.num_conv_pos_embedding_groups),
                   ln_eps=float(getattr(cfg, "layer_norm_eps", 1e-5)))

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        feats = self.feature_extractor(wave).transpose(1, 2)  # (B, T', C)
        return self.encoder(self.feature_projection(feats))


def pos_conv_weight(sd: Mapping[str, Any]) -> np.ndarray:
    """The positional conv's effective weight (out, in / groups, kernel)
    from a state dict without the prefix: as stored, or weight-normed over
    dim 2 from (g, v) in either layout."""
    def arr(key):
        v = sd[key]
        return (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)).astype(
            np.float64)

    if f"{POS_CONV}.weight" in sd:
        return arr(f"{POS_CONV}.weight")
    for g_key, v_key in ((f"{POS_CONV}.parametrizations.weight.original0",
                          f"{POS_CONV}.parametrizations.weight.original1"),
                         (f"{POS_CONV}.weight_g", f"{POS_CONV}.weight_v")):
        if g_key in sd and v_key in sd:
            g, v = arr(g_key), arr(v_key)
            norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
            return g * v / np.maximum(norm, 1e-12)
    raise KeyError(f"positional-conv weight not found under {POS_CONV}.*")


def load_w2v2_weights(module: Wav2Vec2Encoder, state_dict: Mapping[str, Any]) -> None:
    """Load a `Wav2Vec2Model` / `Wav2Vec2ForCTC` state dict into `module`."""
    prefix = "wav2vec2."
    sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state_dict.items()}
    sd[f"{POS_CONV}.weight"] = pos_conv_weight(sd).astype(np.float32)
    load_hf_weights(module, sd, prefix)


def projection_weight(dim: int, hidden: int, seed: int = 0) -> torch.Tensor:
    """The host rung's seeded (dim, hidden) projection head."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(dim, hidden, generator=g) / hidden ** 0.5


class DeviceW2V2Encoder:
    """HF wav2vec2 weights in a `Wav2Vec2Encoder` on `device` (cuda by
    default; raises without a GPU): equal-length waveforms -> (B, dim).

    `model` is an HF `Wav2Vec2Model`, or its state dict with its `config`
    (an HF config or a mapping of its fields). Raises ValueError for what
    `unsupported` names."""

    def __init__(self, model: Any, dim: int = 128, batch_size: int = 16, proj_seed: int = 0,
                 processor: Any = None, device: str = "cuda", config: Any = None):
        cfg, sd = model_parts(model, config)
        reason = unsupported(cfg, processor)
        if reason is not None:
            raise ValueError(f"DeviceW2V2Encoder: {reason}")
        self.device = resolve_device(device)
        self.dim, self.batch_size = int(dim), int(batch_size)
        self.module = Wav2Vec2Encoder.from_config(cfg)
        load_w2v2_weights(self.module, sd)
        self.module.to(self.device).eval()
        hidden = int(cfg.hidden_size)
        self._proj_w = (projection_weight(self.dim, hidden, proj_seed).T.contiguous()
                        .to(self.device) if hidden != self.dim else None)  # (hidden, dim)

    @torch.inference_mode()
    def _pooled(self, chunk: np.ndarray) -> np.ndarray:
        """One chunk of waveforms, padded to its power-of-two batch: (n, dim)."""
        n = chunk.shape[0]
        bb = seq_bucket(n, self.batch_size)
        wave = to_device(torch.from_numpy(np.pad(chunk, ((0, bb - n), (0, 0)))), self.device)
        mu = wave.mean(dim=-1, keepdim=True)
        var = wave.var(dim=-1, unbiased=False, keepdim=True)
        rep = self.module((wave - mu) / torch.sqrt(var + 1e-7)).mean(dim=1)
        if self._proj_w is not None:
            rep = rep @ self._proj_w
        return rep[:n].cpu().numpy()

    def encode_batch(self, waves: Sequence[np.ndarray]) -> np.ndarray:
        """Equal-length mono 16 kHz waveforms -> (B, dim) f32."""
        arr = np.stack([np.asarray(w, np.float32).ravel() for w in waves])
        outs = [self._pooled(arr[s:s + self.batch_size])
                for s in range(0, arr.shape[0], self.batch_size)]
        return np.concatenate(outs, axis=0).astype(np.float32)
