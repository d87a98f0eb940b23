"""LFM2-MoE (`lfm2_moe`, LFM2-8B-A1B) read for its last hidden state, and the
text ladder's pooling, in plain PyTorch: float32, TF32 off, no cache, no
batching of strings beyond the blocks that bound memory, one loop over the
experts.

From the published config and HF's description of the architecture:
token embedding; each layer pre-norm, h = x + mixer(RMSNorm(x)), out = h +
ffn(RMSNorm(h)); a final RMSNorm. RMSNorm: x / sqrt(mean(x^2) + eps) * w.
The mixer of a "conv" layer: B, C, xs = in_proj(x) split in three over
channels; y[t] = sum_j w[:, j] * (B * xs)[t - (L - 1) + j] (a depthwise
causal convolution of kernel L, zero before the first token); out_proj(C *
y). Of a "full_attention" layer: q, k, v projections, RMSNorm over each
head's width on q and k, RoPE (rotate-half, theta from the config) at the
token's position, each query head reading KV head h // (H / KV), softmax(q
k^T / sqrt(D)) over the keys at or before the query that the mask keeps,
out_proj. Dense FFN: w2(silu(w1 x) * w3 x). Expert layer: scores =
sigmoid(gate x); the k experts of highest scores + expert_bias; gates the
chosen scores over their sum + 1e-6, times routed_scaling_factor; the sum
of each chosen expert's SwiGLU times its gate. Then the mean over the real
tokens, cut or zero-padded to `dim`, L2-normalised (+1e-9). Weights use
the published checkpoint's key names (without `model.`).

Routing as the program routed (`routes`): the discrete top-k choice flips
between bf16 and f32 where the scores nearly tie, and a flipped token's
expert output is another function, which the later layers carry on: at
published widths those flips, not the arithmetic, set the gap between a
sound bf16 run and this reference (PERF.md §2). Given the experts the
program chose for each real token of each expert layer, the reference
takes those (their gates its own f32 scores at them, normalised as above)
and reports how far each choice is from its own: the largest, over
tokens, of its k-th highest score + bias less the lowest score + bias
among the program's experts (0 where they agree). `expert_layer` runs one
expert layer alone, on given input rows, for a comparison layer by layer;
`route_gap` its router alone, for the program's choices on its own input.

Departures: none in the function; the LM head is not computed (the rung
reads hidden states). Padded positions are computed like any other and
ignored by the pooling; with right padding and causal mixers no real
position reads them."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.bert_encoder import Spec, matmul_precision

# The leaves the program holds in f32 (the router); the others it holds in
# the configuration's bf16, and the reference takes them rounded so.
F32_LEAVES = ("feed_forward.gate.weight", "feed_forward.expert_bias")


def param_spec(cfg: Dict[str, Any]) -> Dict[str, Spec]:
    """{"lm": [(key, shape, mean, std)]}: N(0, std) for every matrix, 1 +
    N(0, std) for the norm scales, N(0, conv_std) for the conv kernels (a
    variance-keeping draw for their fan-in of L) and N(0, expert_bias_std)
    for the expert bias (the stds under the configuration's `weights`;
    `even_bias_` then fixes the bias's values, the draw their order)."""
    w, i, mi = cfg["hidden_size"], cfg["intermediate_size"], cfg["moe_intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d, e, k = w // h, cfg["num_experts"], cfg["conv_L_cache"]
    std = cfg["weights"]["std"]
    out = cfg["weights"].get("out_std", std)  # the projections back to the residual
    spec: Spec = [("embed_tokens.weight", (cfg["vocab_size"], w), 0.0, std)]
    for layer in range(cfg["num_hidden_layers"]):
        p = f"layers.{layer}."
        if cfg["layer_types"][layer] == "full_attention":
            spec += [(p + "self_attn.q_proj.weight", (h * d, w), 0.0, std),
                     (p + "self_attn.k_proj.weight", (kv * d, w), 0.0, std),
                     (p + "self_attn.v_proj.weight", (kv * d, w), 0.0, std),
                     (p + "self_attn.out_proj.weight", (w, h * d), 0.0, out),
                     (p + "self_attn.q_layernorm.weight", (d,), 1.0, std),
                     (p + "self_attn.k_layernorm.weight", (d,), 1.0, std)]
        else:
            spec += [(p + "conv.in_proj.weight", (3 * w, w), 0.0, std),
                     (p + "conv.conv.weight", (w, 1, k), 0.0, cfg["weights"]["conv_std"]),
                     (p + "conv.out_proj.weight", (w, w), 0.0, out)]
        f = p + "feed_forward."
        if layer < cfg["num_dense_layers"]:
            spec += [(f + "w1.weight", (i, w), 0.0, std), (f + "w3.weight", (i, w), 0.0, std),
                     (f + "w2.weight", (w, i), 0.0, out)]
        else:
            spec += [(f + "gate.weight", (e, w), 0.0, std),
                     (f + "expert_bias", (e,), 0.0, cfg["weights"]["expert_bias_std"])]
            for x in range(e):
                ex = f + f"experts.{x}."
                spec += [(ex + "w1.weight", (mi, w), 0.0, std),
                         (ex + "w3.weight", (mi, w), 0.0, std),
                         (ex + "w2.weight", (w, mi), 0.0, out)]
        spec += [(p + "operator_norm.weight", (w,), 1.0, std),
                 (p + "ffn_norm.weight", (w,), 1.0, std)]
    spec.append(("embedding_norm.weight", (w,), 1.0, std))
    return {"lm": spec}


def even_bias_(cfg: Dict[str, Any], wts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each layer's drawn expert bias replaced in place by the normal
    quantiles of `expert_bias_std` at the ranks of its draw: the seed picks
    which expert gets which value, not how far apart the values lie, so that
    every seed routes about as unevenly (a draw's spread and largest value
    moved the cell's tokens a second by ~3% from seed to seed)."""
    e = cfg["num_experts"]
    q = torch.special.ndtri((torch.arange(e, dtype=torch.float64) + 0.5) / e)
    q = (q * cfg["weights"]["expert_bias_std"]).to(torch.float32)
    for name, t in wts.items():
        if name.endswith("expert_bias"):
            t.copy_(q.to(t.device)[torch.argsort(torch.argsort(t))])
    return wts


def as_program_holds(wts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights in place as the program holds them, in f32: each leaf
    rounded to bf16, the router's (F32_LEAVES) as drawn."""
    for name, t in wts.items():
        if not name.endswith(F32_LEAVES):
            t.copy_(t.to(torch.bfloat16))
    return wts


def _rms(x, wt, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * wt


def _rope(x, theta):
    """x (N, S, H, D) rotated at positions 0 .. S - 1."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv[None]
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]  # (S, 1, D / 2)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)


def _swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1.t()) * (x @ w3.t())) @ w2.t()


def _conv(cfg, wts, p, x):
    n, s, w = x.shape
    gate_b, gate_c, xs = (x @ wts[p + "conv.in_proj.weight"].t()).split(w, dim=-1)
    bx = gate_b * xs
    kern = wts[p + "conv.conv.weight"][:, 0]  # (W, L)
    big = kern.shape[1]
    y = torch.zeros_like(bx)
    for j in range(big):
        shift = big - 1 - j  # tap j reads the token `shift` before
        y[:, shift:] += kern[:, j] * bx[:, :s - shift]
    return (gate_c * y) @ wts[p + "conv.out_proj.weight"].t()


def _attention(cfg, wts, p, x, keep):
    n, s, w = x.shape
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d, eps = w // h, cfg["norm_eps"]
    a = p + "self_attn."
    q = _rms((x @ wts[a + "q_proj.weight"].t()).view(n, s, h, d),
             wts[a + "q_layernorm.weight"], eps)
    k = _rms((x @ wts[a + "k_proj.weight"].t()).view(n, s, kv, d),
             wts[a + "k_layernorm.weight"], eps)
    v = (x @ wts[a + "v_proj.weight"].t()).view(n, s, kv, d)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    group = torch.arange(h, device=x.device) // (h // kv)
    k, v = k[:, :, group], v[:, :, group]  # query head h reads KV head h // (H / KV)
    scores = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(d)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~(causal[None, None] & keep[:, None, None, :]), float("-inf"))
    out = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(scores, dim=-1), v)
    return out.reshape(n, s, h * d) @ wts[a + "out_proj.weight"].t()


def _choose(cfg, wts, f, x, forced=None):
    """x (T, W) -> (scores (T, E), the experts taken (T, k), route gap): the
    k of highest score + bias, or `forced` (T, k) where given (-1: its own
    choice), and the largest shortfall of a forced choice from its own."""
    scores = torch.sigmoid(x @ wts[f + "gate.weight"].t())
    chosen = scores + wts[f + "expert_bias"] if cfg["use_expert_bias"] else scores
    best = torch.topk(chosen, cfg["num_experts_per_tok"], dim=-1)
    top, gap = best.indices, 0.0
    if forced is not None:
        given = forced[:, 0] >= 0
        if bool(given.any()):
            kth = best.values[given, -1]
            gap = float((kth - chosen[given].gather(1, forced[given]).amin(dim=1)).max())
            top = torch.where(given[:, None], forced.clamp_min(0), top)
    return scores, top, gap


def _experts(cfg, wts, f, x, forced=None):
    """x (T, W) -> ((T, W), route gap): each token's chosen experts, gated
    and summed; `forced` (T, k) the experts to take (-1: its own choice)."""
    scores, top, gap = _choose(cfg, wts, f, x, forced)
    gates = scores.gather(1, top)
    if cfg["norm_topk_prob"]:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-6)
    gates = gates * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        tok, slot = (top == e).nonzero(as_tuple=True)
        if tok.numel():
            ex = f + f"experts.{e}."
            y = _swiglu(x[tok], wts[ex + "w1.weight"], wts[ex + "w3.weight"], wts[ex + "w2.weight"])
            out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out, gap


def route_gap(cfg: Dict[str, Any], wts: Dict[str, torch.Tensor], layer: int, x: torch.Tensor,
              taken: torch.Tensor) -> float:
    """One expert layer's router alone, on its input rows x (T, W) (after
    `ffn_norm`), against the experts `taken` (T, k) for them: the largest
    shortfall, in score + bias, of a taken expert from the k-th of the
    reference's own choice (0 where they agree), TF32 off. `wts` needs the
    layer's `gate.weight` and `expert_bias` alone."""
    with matmul_precision(False):
        return _choose(cfg, wts, f"layers.{layer}.feed_forward.", x, taken)[2]


def expert_layer(cfg: Dict[str, Any], wts: Dict[str, torch.Tensor], layer: int, x: torch.Tensor,
                 forced: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, float]:
    """One expert layer on its input rows x (T, W) (after `ffn_norm`): ((T,
    W), the route gap), TF32 off."""
    with matmul_precision(False):
        return _experts(cfg, wts, f"layers.{layer}.feed_forward.", x, forced)


def hidden(cfg: Dict[str, Any], wts: Dict[str, torch.Tensor], ids: torch.Tensor,
           mask: torch.Tensor, routes: Optional[Dict[int, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, float]:
    """ids (N, S) int, mask (N, S) 1/0, right-padded -> ((N, S, W) f32, the
    last hidden state after the final norm; the route gap). `routes`:
    {layer: (N, S, k) experts each position took in the program, -1 where
    none (padding)}."""
    eps, gap = cfg["norm_eps"], 0.0
    keep = mask.bool()
    x = wts["embed_tokens.weight"][ids].float()
    for layer in range(cfg["num_hidden_layers"]):
        p = f"layers.{layer}."
        a = _rms(x, wts[p + "operator_norm.weight"], eps)
        if cfg["layer_types"][layer] == "full_attention":
            x = x + _attention(cfg, wts, p, a, keep)
        else:
            x = x + _conv(cfg, wts, p, a)
        f = p + "feed_forward."
        b = _rms(x, wts[p + "ffn_norm.weight"], eps)
        if layer < cfg["num_dense_layers"]:
            x = x + _swiglu(b, wts[f + "w1.weight"], wts[f + "w3.weight"], wts[f + "w2.weight"])
        else:
            forced = routes[layer].reshape(-1, routes[layer].shape[-1]) if routes else None
            out, g = _experts(cfg, wts, f, b.reshape(-1, b.shape[-1]), forced)
            x, gap = x + out.view_as(b), max(gap, g)
    return _rms(x, wts["embedding_norm.weight"], eps), gap


@torch.no_grad()
def encode(cfg: Dict[str, Any], wts: Dict[str, torch.Tensor], ids: torch.Tensor,
           mask: torch.Tensor, dim: int, routes: Optional[Dict[int, torch.Tensor]] = None,
           block: int = 256) -> Tuple[torch.Tensor, float]:
    """ids (N, L) int, mask (N, L) 1/0 -> ((N, dim) f32 rows, the route gap;
    0 without `routes`), `block` strings at a time, taken in order of length
    so that a block pads little (each string alone is the same function)."""
    rows, gap = [], 0.0
    order = torch.argsort(mask.sum(dim=1), stable=True)
    with matmul_precision(False):
        for s in range(0, ids.shape[0], block):
            take = order[s:s + block]
            i, m = ids[take], mask[take]
            width = max(int(m.sum(dim=1).max()), 1)
            i, m = i[:, :width], m[:, :width]
            r = ({k: v[take.cpu(), :width].to(ids.device, torch.int64)
                  for k, v in routes.items()} if routes else None)
            x, g = hidden(cfg, wts, i, m, r)
            gap = max(gap, g)
            mm = m.to(x.dtype)[..., None]
            rows.append((x * mm).sum(dim=1) / mm.sum(dim=1).clamp_min(1e-6))
    pooled = torch.empty_like(torch.cat(rows))
    pooled[order] = torch.cat(rows)
    if pooled.shape[1] > dim:
        pooled = pooled[:, :dim]
    elif pooled.shape[1] < dim:
        pooled = F.pad(pooled, (0, dim - pooled.shape[1]))
    return pooled / (pooled.norm(dim=-1, keepdim=True) + 1e-9), gap
