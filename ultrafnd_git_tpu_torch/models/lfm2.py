"""LFM2-MoE (LiquidAI's `lfm2_moe`, LFM2-8B-A1B) as the text ladder's
language-model rung: a hybrid of gated short convolutions and grouped-query
attention, with a routed top-k expert layer, read for its hidden states.

The stack, from the published config (`hidden_size`, `layer_types`, ...):
`embed_tokens`, then `num_hidden_layers` pre-norm layers, each

    h = x + mixer(operator_norm(x)),   out = h + feed_forward(ffn_norm(h)),

and `embedding_norm` (RMSNorm) after the last. The mixer is `conv`
(`ShortConv`) or, at the layers `layer_types` names "full_attention",
`self_attn` (`CausalAttention`); the first `num_dense_layers` feed-forwards
are SwiGLU `w2(silu(w1 x) * w3 x)` of width `intermediate_size`, the others
`SparseMoe` over `num_experts` SwiGLU experts of width
`moe_intermediate_size`.

* `ShortConv`: `B, C, xs = in_proj(x).chunk(3)` over channels, a depthwise
  causal conv1d of kernel `conv_L_cache` over the sequence on `B * xs`
  (left-padded by L - 1, cut to S), then `out_proj(C * conv)`; bias-free
  (`conv_bias` false).
* `CausalAttention`: q, k, v projections of 32 query and 8 KV heads of 64,
  RMSNorm over the head width on q and k (`q_layernorm`, `k_layernorm`),
  RoPE (rotate-half, `rope_theta`) at positions 0 .. S - 1, the KV heads
  repeated to the query heads (query head h reads KV head h // 4), then K2
  bf16's causal mode (`kernels/flash_attention.flash_attention_fwd_bf16_causal`)
  over the (B, 1, 1, S) key-padding bias, then `out_proj`; bias-free.
* `SparseMoe`: router logits `gate(x)` in f32 (the gate's weight is kept in
  f32), scores `sigmoid(logits)`, the `num_experts_per_tok` experts chosen by
  `topk(scores + expert_bias)` (`use_expert_bias`), gates the chosen scores
  without the bias, over their sum + 1e-6 (`norm_topk_prob`), times
  `routed_scaling_factor`; no token dropped. The token-expert rows are
  sorted by expert into one contiguous buffer (`lm.moe.route`); each
  expert's rows run its SwiGLU with w1 and w3 fused into one product
  (`lm.moe.experts`): `torch._grouped_mm` over the sorted buffer with the
  offsets on the device (no host sync) for bf16 on a CUDA device, else one
  product an expert on its slice (one sync a layer, for the offsets).

Weights and activations are bf16 on the card (`dtype`), the products sum
in f32; the norms, RoPE and the softmax run in f32, the router in f32.
`dtype=torch.float32` is the CPU tests' mode (their attention the plain
causal version).

Padded positions: chunks are right-padded, and both mixers are causal, so
a real position reads real positions alone; a padded one's output is never
read. The expert layer takes the real positions alone (`real`, their flat
indices, made by the wrapper on the host), so padding costs no expert work
and does not count in the routing counters (kept only while spans are
recorded); the dense layers run every position.

Departures from the published description, and points not confirmed
without the checkpoint's files:
* The expert weights are held stacked: `feed_forward.w13` (E, 2I, W), the
  rows of w1 then of w3, and `feed_forward.w2` (E, W, I). `load_weights`
  fills them from the published per-expert keys
  `feed_forward.experts.{e}.w1/w3/w2.weight` (the layout of HF's
  `Lfm2MoeSparseMoeBlock` with a ModuleList of experts; unconfirmed).
* Each expert's output is scaled by its gate before its w2 product (w2 is
  linear, so it is the same sum), and a token's k rows are summed after the
  rows are put back in token order, rather than by `index_add_`: no atomic
  adds, so two calls give the same bits, and no f32 copy of the rows.
* RMSNorm scales in f32 and rounds once (HF rounds to the input's dtype
  before the scale); the HF reference also zeroes padded positions before a
  conv, which with right padding changes no real position.
* The LM head is not built: the rung reads the last hidden state.
* `max_position_embeddings` does not bound anything here: the ladder's
  strings are at most `max_length` tokens.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.kernels.flash_attention import (
    flash_attention_fwd_bf16_causal,
    padding_bias,
    reference_attention,
    reference_attention_bf16,
)
from ultrafnd_git_tpu_torch.models.bert import Attention, ChunkedEncoder, hf_config
from ultrafnd_git_tpu_torch.utils.device import resolve_device
from ultrafnd_git_tpu_torch.utils import spans
from ultrafnd_git_tpu_torch.utils.spans import span

# Counts of the expert layers while spans are recorded (`spans.recording`):
# calls, token-expert rows routed (host ints), and on each device the sum
# over calls of the busiest expert's rows and of the experts left empty
# (device scalars, read by `moe_counters`, which syncs). A call outside a
# recording counts nothing and launches nothing for them.
moe_calls = 0
moe_rows = 0
_device_counts: Dict[torch.device, torch.Tensor] = {}
_COUNT_LOCK = threading.Lock()


def moe_counters() -> Dict[str, int]:
    """{"calls", "rows", "busiest_rows", "empty_experts"} of the recorded
    calls since import, summed over devices (syncs each device that holds
    counts)."""
    with _COUNT_LOCK:
        busiest = empty = 0
        for t in _device_counts.values():
            b, e = t.tolist()
            busiest, empty = busiest + int(b), empty + int(e)
        return {"calls": moe_calls, "rows": moe_rows, "busiest_rows": busiest,
                "empty_experts": empty}


def _count(rows: int, counts: torch.Tensor) -> None:
    global moe_calls, moe_rows
    if not spans.active():
        return
    with _COUNT_LOCK:
        moe_calls += 1
        moe_rows += rows
        acc = _device_counts.get(counts.device)
        if acc is None:
            with torch.inference_mode(False):  # added to in and out of inference mode
                acc = _device_counts[counts.device] = torch.zeros(
                    2, dtype=torch.int64, device=counts.device)
        acc[0] += counts.max()
        acc[1] += (counts == 0).sum()


def causal_attention(q, k, v, bias) -> torch.Tensor:
    """The rung's attention: K2-bf16's causal mode for bf16 (its plain
    version on the CPU), the plain causal version for f32 on the CPU; f32 on
    a CUDA device raises (no f32 causal kernel)."""
    if q.dtype == torch.bfloat16:
        return flash_attention_fwd_bf16_causal(q, k, v, bias)[0]
    if q.device.type != "cpu":
        raise ValueError("no causal f32 attention kernel: run the LM rung in bf16 on the card")
    return reference_attention(q, k, v, bias, causal=True)[0]


def plain_causal_attention(q, k, v, bias) -> torch.Tensor:
    """The causal kernel's plain version (bf16 twin, or f32), on any device."""
    if q.dtype == torch.bfloat16:
        return reference_attention_bf16(q, k, v, bias, causal=True)[0]
    return reference_attention(q, k, v, bias, causal=True)[0]


def rms_f32(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight.float()


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float, dtype=None):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(width, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_f32(x, self.weight, self.eps).to(x.dtype)


def rope_tables(seq: int, dim: int, theta: float, device) -> tuple:
    """(cos, sin) (S, D) f32 of positions 0 .. S - 1, rotate-half layout."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim))
    freqs = torch.arange(seq, device=device, dtype=torch.float32)[:, None] * inv[None]
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) f32 rotated at its positions."""
    half = x.shape[-1] // 2
    rot = torch.cat((-x[..., half:], x[..., :half]), dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def _linear(d_in: int, d_out: int, dtype) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, dtype=dtype)


class ShortConv(nn.Module):
    def __init__(self, width: int, kernel: int, dtype=None):
        super().__init__()
        self.in_proj = _linear(width, 3 * width, dtype)
        self.conv = nn.Conv1d(width, width, kernel, groups=width, padding=kernel - 1,
                              bias=False, dtype=dtype)
        self.out_proj = _linear(width, width, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate_b, gate_c, xs = self.in_proj(x).chunk(3, dim=-1)
        conv = self.conv((gate_b * xs).transpose(1, 2))[..., :x.shape[1]]
        return self.out_proj(gate_c * conv.transpose(1, 2))


class CausalAttention(Attention):
    attend = staticmethod(causal_attention)

    def __init__(self, width: int, heads: int, kv_heads: int, eps: float, dtype=None):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, width // heads
        d = self.head_dim
        self.q_proj = _linear(width, heads * d, dtype)
        self.k_proj = _linear(width, kv_heads * d, dtype)
        self.v_proj = _linear(width, kv_heads * d, dtype)
        self.out_proj = _linear(heads * d, width, dtype)
        self.q_layernorm = RMSNorm(d, eps, dtype)
        self.k_layernorm = RMSNorm(d, eps, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, rope: tuple) -> torch.Tensor:
        b, s, _ = x.shape
        d, rep = self.head_dim, self.heads // self.kv_heads

        def heads_of(proj, norm, n):
            t = proj(x).view(b, s, n, d)
            if norm is not None:
                t = apply_rope(rms_f32(t, norm.weight, norm.eps), *rope).to(x.dtype)
            return t.repeat_interleave(rep, dim=2) if n != self.heads else t

        q, k, v = (heads_of(self.q_proj, self.q_layernorm, self.heads),
                   heads_of(self.k_proj, self.k_layernorm, self.kv_heads),
                   heads_of(self.v_proj, None, self.kv_heads))
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out = self.attend(q, k, v, bias)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, self.heads * d))


class SwiGLU(nn.Module):
    def __init__(self, width: int, inner: int, dtype=None):
        super().__init__()
        self.w1 = _linear(width, inner, dtype)
        self.w3 = _linear(width, inner, dtype)
        self.w2 = _linear(inner, width, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def _grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows of x (sorted by expert, expert e's ending at offs[e]) times
    their expert's w[e]^T (w (E, N, K)): one grouped product."""
    return torch._grouped_mm(x, w.transpose(1, 2), offs=offs)


def _per_expert(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The same, one product an expert on its slice (the offsets to the host)."""
    out = x.new_empty((x.shape[0], w.shape[1]))
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e].t()
        start = end
    return out


def grouped_products(x: torch.Tensor) -> Callable:
    """The expert product the layer uses for `x`: grouped on a CUDA device
    in bf16 where torch has `_grouped_mm`, else one product an expert."""
    if x.is_cuda and x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        return _grouped
    return _per_expert


class SparseMoe(nn.Module):
    def __init__(self, width: int, inner: int, experts: int, top_k: int, norm_topk: bool,
                 scaling: float, use_bias: bool, dtype=None):
        super().__init__()
        self.top_k, self.norm_topk, self.scaling = int(top_k), bool(norm_topk), float(scaling)
        self.use_bias = bool(use_bias)
        self.gate = _linear(width, experts, torch.float32)
        self.register_buffer("expert_bias", torch.zeros(experts, dtype=torch.float32))
        self.w13 = nn.Parameter(torch.empty(experts, 2 * inner, width, dtype=dtype))
        self.w2 = nn.Parameter(torch.empty(experts, width, inner, dtype=dtype))
        self.products: Optional[Callable] = None  # None: grouped_products(x)

    def route(self, x: torch.Tensor):
        """(selected (T, k), gates (T, k) f32) of tokens x (T, W)."""
        scores = F.linear(x.float(), self.gate.weight.float()).sigmoid()
        chosen = scores + self.expert_bias if self.use_bias else scores
        selected = torch.topk(chosen, self.top_k, dim=-1).indices
        gates = scores.gather(1, selected)
        if self.norm_topk:
            gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-6)
        return selected, gates * self.scaling

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (T, W) -> (T, W): each token's k experts, gated and summed."""
        t, k, e = x.shape[0], self.top_k, self.w13.shape[0]
        with span("lm.moe.route"):
            selected, gates = self.route(x)
            flat = selected.flatten()
            order = torch.argsort(flat, stable=True)  # rows sorted by expert
            counts = torch.zeros(e, dtype=torch.int32, device=x.device).index_add_(
                0, flat, torch.ones_like(flat, dtype=torch.int32))
            offs = torch.cumsum(counts, 0, dtype=torch.int32)
            rows = x.index_select(0, order // k)
            _count(t * k, counts)
        with span("lm.moe.experts"):
            products = self.products or grouped_products(x)
            up, gated = products(rows, self.w13, offs).chunk(2, dim=-1)
            h = F.silu(up) * gated
            h.mul_(gates.flatten().index_select(0, order)[:, None])
            y = products(h, self.w2, offs)
            back = torch.empty_like(order)
            back[order] = torch.arange(order.numel(), device=x.device)
            return y.index_select(0, back).view(t, k, -1).sum(dim=1)


class Lfm2Layer(nn.Module):
    def __init__(self, cfg: Any, index: int, dtype=None):
        super().__init__()
        w, eps = cfg.hidden_size, float(cfg.norm_eps)
        self.is_attention = cfg.layer_types[index] == "full_attention"
        if self.is_attention:
            self.self_attn = CausalAttention(w, cfg.num_attention_heads,
                                             cfg.num_key_value_heads, eps, dtype)
        else:
            self.conv = ShortConv(w, cfg.conv_L_cache, dtype)
        self.is_dense = index < cfg.num_dense_layers
        if self.is_dense:
            self.feed_forward = SwiGLU(w, cfg.intermediate_size, dtype)
        else:
            self.feed_forward = SparseMoe(
                w, cfg.moe_intermediate_size, cfg.num_experts, cfg.num_experts_per_tok,
                cfg.norm_topk_prob, cfg.routed_scaling_factor, cfg.use_expert_bias, dtype)
        self.operator_norm = RMSNorm(w, eps, dtype)
        self.ffn_norm = RMSNorm(w, eps, dtype)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, rope: tuple,
                real: Optional[torch.Tensor]) -> torch.Tensor:
        if self.is_attention:
            with span("lm.attention"):
                h = x + self.self_attn(self.operator_norm(x), bias, rope)
        else:
            with span("lm.conv"):
                h = x + self.conv(self.operator_norm(x))
        if self.is_dense:
            with span("lm.dense_ffn"):
                return h + self.feed_forward(self.ffn_norm(h))
        flat = h.view(-1, h.shape[-1])
        tokens = flat if real is None else flat.index_select(0, real)
        out = self.feed_forward(self.ffn_norm(tokens))
        if real is None:
            return h + out.view_as(h)
        return flat.index_add_(0, real, out).view_as(h)  # each real row once


def rope_theta(cfg: Any) -> float:
    """`rope_theta`, or `rope_parameters["rope_theta"]` (newer configs)."""
    theta = getattr(cfg, "rope_theta", None)
    if theta is None:
        theta = (getattr(cfg, "rope_parameters", None) or {}).get("rope_theta")
    return float(theta)


class Lfm2Model(nn.Module):
    """HF's `Lfm2MoeModel` without its cache: ids, mask -> the last hidden
    state after `embedding_norm`."""

    def __init__(self, cfg: Any, dtype=None):
        super().__init__()
        cfg = hf_config(cfg)
        self.theta = rope_theta(cfg)
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(Lfm2Layer(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.embedding_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                real: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids (B, S) int, mask (B, S) 1/0 (right-padded), `real` the flat
        indices of the real positions (None: every position goes through the
        expert layers) -> (B, S, width) in the model's dtype."""
        x = self.embed_tokens(ids)
        bias = padding_bias(mask, x.dtype)
        rope = rope_tables(ids.shape[1], self.head_dim, self.theta, ids.device)
        for layer in self.layers:
            x = layer(x, bias, rope, real)
        return self.embedding_norm(x)


def load_weights(module: Lfm2Model, state_dict: Mapping[str, Any], prefix: str = "model.") -> None:
    """Copy a published-layout state dict (keys with or without `prefix`,
    tensors of any float dtype on any device) into `module`'s tensors, in
    their dtype and on their device; the experts' per-expert keys fill the
    stacked `w13` / `w2`. Every tensor of the module must be there; keys it
    has no use for (the LM head) are ignored."""
    sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state_dict.items()}
    missing = []
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            layer, _, leaf = name.rpartition(".")
            if leaf in ("w13", "w2") and layer.endswith("feed_forward") and t.dim() == 3:
                inner = module.get_submodule(layer).w2.shape[2]
                for e in range(t.shape[0]):
                    ex = f"{layer}.experts.{e}."
                    parts = ((ex + "w1.weight", ex + "w3.weight") if leaf == "w13"
                             else (ex + "w2.weight",))
                    if any(p not in sd for p in parts):
                        missing += [p for p in parts if p not in sd]
                        continue
                    for j, p in enumerate(parts):  # w13: w1's rows, then w3's
                        dest = t[e, j * inner:(j + 1) * inner] if leaf == "w13" else t[e]
                        dest.copy_(torch.as_tensor(sd[p]))
            elif name in sd:
                t.copy_(torch.as_tensor(sd[name]))
            else:
                missing.append(name)
    if missing:
        raise KeyError(f"Lfm2Model: weights missing {missing[:5]}"
                       + (f" and {len(missing) - 5} more" if len(missing) > 5 else ""))


def build(cfg: Any, state_dict: Mapping[str, Any], device, dtype=torch.bfloat16) -> Lfm2Model:
    """The model in `dtype` on `device`, its tensors allocated there and
    filled from `state_dict` (no copy on the host, no initialisation)."""
    with torch.device("meta"):
        module = Lfm2Model(cfg, dtype)
    module = module.to_empty(device=device)
    load_weights(module, state_dict)
    return module.eval().requires_grad_(False)


def held_to_plain(module: nn.Module) -> Dict[str, float]:
    """Route every causal attention and expert product of `module` through
    its card path and its plain version (`plain_causal_attention`, one
    product an expert) on the same operands, keeping the card path's
    output, so that the routing of one is the other's: the returned dict
    keeps {"attention", "experts"}, each the largest gap over the plain
    output's largest value. For the card's tests and `chip_smoke.py`."""
    from ultrafnd_git_tpu_torch.models.bert import set_attention

    gaps = {"attention": 0.0, "experts": 0.0}

    def rel(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    def attend(q, k, v, bias):
        out = causal_attention(q, k, v, bias)
        gaps["attention"] = max(gaps["attention"],
                                rel(out, plain_causal_attention(q, k, v, bias)))
        return out

    def products(x, w, offs):
        out = grouped_products(x)(x, w, offs)
        gaps["experts"] = max(gaps["experts"], rel(out, _per_expert(x, w, offs)))
        return out

    set_attention(module, attend)
    for m in module.modules():
        if isinstance(m, SparseMoe):
            m.products = products
    return gaps


def layer_flops(cfg: Any) -> Callable[[int, int], float]:
    """The planner's cost of a chunk padded to (rows, seq): the FLOPs of the
    mean layer over every padded position, the expert layers left out (they
    take the real positions alone, whatever the plan). A conv layer 8 W^2 a
    position (in_proj, out_proj), an attention layer 4 W^2 + 4 W KV D and
    2 S W (the causal half of Q K^T and P V), a dense layer 6 W I."""
    cfg = hf_config(cfg)
    w, depth = cfg.hidden_size, cfg.num_hidden_layers
    attn = sum(t == "full_attention" for t in cfg.layer_types)
    kv = cfg.num_key_value_heads * (w // cfg.num_attention_heads)
    dense = cfg.num_dense_layers * 6.0 * w * cfg.intermediate_size
    fixed = (depth - attn) * 8.0 * w * w + attn * (4.0 * w * w + 4.0 * w * kv) + dense

    def flops(rows: int, seq: int) -> float:
        return rows * seq * (fixed + attn * 2.0 * seq * w) / depth

    return flops


# A chunk's fixed cost to the planner, a layer, in FLOPs at the rate of the
# chunk's own work (`ChunkedEncoder.chunk_cost`). Measured at LFM2-8B-A1B's
# widths on an H100 80GB HBM3 (700 W), bf16, by `scripts/lfm2_chunk_cost.py`:
# one chunk's forward at 20 (rows, sequence) points from (8, 32) to (256,
# 256), every position real, fit as FLOPs / rate + fixed: 363 TFLOP/s and
# 37.6 ms a chunk, 5.7e11 FLOPs a layer. No chunk took under 48.8 ms (the
# host launches a chunk's ~2,000 operations; (8, 32) ran at 14 TFLOP/s,
# (256, 256) at 267).
CHUNK_LAYER_FLOPS = 5.7e11


class DeviceLfm2Encoder(ChunkedEncoder):
    """LFM2-MoE weights in an `Lfm2Model` on `device` (cuda by default;
    raises without a GPU), in `dtype` (bf16; f32 for the CPU tests), over
    `ChunkedEncoder`'s request path: strings -> (N, dim) rows, the mean of
    the last hidden state (after `embedding_norm`) over each string's
    tokens, fit to `dim` and L2-normalised.

    `state_dict` holds the published checkpoint's tensors (keys with or
    without `model.`; the LM head's are ignored), `config` its config (an
    HF config or a mapping of its fields); the module's tensors are made on
    the device and filled from it, so the caller may free its copy after.
    `from_files(path)` reads a local directory of the published files.
    `encode_ids` is the entry the benchmark drives.
    """

    wants_real = True

    def __init__(self, state_dict: Mapping[str, Any], tokenizer: Any, config: Any,
                 dim: int = 768, max_length: int = 256, batch_size: int = 256,
                 device: str = "cuda", dtype=torch.bfloat16):
        cfg = hf_config(config)
        self.device = resolve_device(device)
        self.dim, self.max_length, self.batch_size = int(dim), int(max_length), int(batch_size)
        self.width = int(cfg.hidden_size)
        self.layer_flops = layer_flops(cfg)
        self.tok = tokenizer
        self.module = build(cfg, state_dict, self.device, dtype)

    @property
    def chunk_cost(self) -> float:
        return CHUNK_LAYER_FLOPS  # read at each plan

    def forward(self, ids, mask, real=None):
        return self.module(ids, mask, real)

    @classmethod
    def from_files(cls, path: str, **kwargs) -> "DeviceLfm2Encoder":
        """The published files in the local directory `path`: config.json,
        the *.safetensors shards and the tokenizer's files."""
        import json
        from pathlib import Path

        from safetensors.torch import load_file

        from ultrafnd_git_tpu_torch.utils.hf import import_transformers

        root = Path(path)
        config = json.loads((root / "config.json").read_text())
        shards = sorted(root.glob("*.safetensors"))
        if not shards:
            raise FileNotFoundError(f"no *.safetensors under {root}")
        state = {}
        for shard in shards:
            state.update(load_file(str(shard)))
        tok = import_transformers().AutoTokenizer.from_pretrained(str(root),
                                                                  local_files_only=True)
        return cls(state, tok, config, **kwargs)
