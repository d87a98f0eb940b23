"""The v2 tower model's training step, in plain PyTorch.

Data: per record text (768), audio, visual, temporal features, two aux
scalars, a label, the tower's token ids and mask, and an OCR token set.

* Graph: A[i, j] = 1 where the OCR Jaccard |s_i & s_j| / (|s_i | s_j| +
  1e-9) reaches the threshold, A[i, i] = 1; a_norm = D^-1/2 (A + I) D^-1/2
  with D the row sums of A + I (+1e-9); node features xg = the first
  192 / 32 / 128 / 64 columns of text / audio / visual / temporal, each row
  L2-normalised (+1e-9); ax = a_norm xg.
* Tower: token and position embeddings, LayerNorm (eps 1e-6), pre-LN
  blocks x += drop(attn(LN x)), x += drop(W2 gelu_tanh(W1 LN x)), a final
  LayerNorm, the mean over real tokens, L2-normalised (+1e-9).
* GCN: lin2(a_norm[rows] drop(gelu(lin1(ax)))) over all N nodes' hidden.
* Fusion: per-modality projections to H; evidence proxies (1 - cos01(t,
  v), tanh(mean |t|), 1 - cos01(t, u), no gradient); three gated
  co-attentions gate * (sigmoid(q.k / sqrt(H)) v) + (1 - gate) (x + y) / 2;
  eight pair features; the GCN feature projected; a two-layer erf-GELU MLP
  with dropout after each GELU.
* Classifier: [fused, aux] through a two-layer erf-GELU MLP with dropout;
  a forest of soft oblivious trees (feature choice softmax(gates) over the
  features, right probability sigmoid(tau (choice - threshold)), leaf
  probability the product over depths, per-tree logits mixed from the
  leaves) with dropout on the per-tree logits and their mean, plus a linear
  bypass. The loss is the masked mean cross-entropy of those logits.
* Optimizer: clip by the global norm, then AdamW in optax's order
  (m, v; bias-corrected m / (sqrt(v) + eps) + wd p; p -= lr u), the
  learning rate lr * rate ** floor(count / (every * steps an epoch)).

Dropout keeps with probability 1 - rate and scales by 1 / (1 - rate); its
keep masks are inputs of `run_steps` (the masks a run drew, in the order
the sites draw them), so the reference steps the function the run stepped.
Weights use the port's state-dict names.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.bert_encoder import Spec, matmul_precision

Tree = Dict[str, Dict[str, torch.Tensor]]


def param_spec(cfg: Dict[str, Any]) -> Dict[str, Spec]:
    """{part: [(name, shape, mean, std)]} of every trainable leaf. Matrices
    N(0, 1 / fan_in), norm scales 1 + N(0, 0.02), other vectors and the
    temperature N(0, 0.02) around 0 and 1."""
    t, f, c, g, corpus = cfg["tower"], cfg["fusion"], cfg["classifier"], cfg["gnn"], cfg["corpus"]

    def dense(name, n_in, n_out):
        return [(name + ".weight", (n_out, n_in), 0.0, n_in ** -0.5),
                (name + ".bias", (n_out,), 0.0, 0.02)]

    def norm(name, width):
        return [(name + ".weight", (width,), 1.0, 0.02), (name + ".bias", (width,), 0.0, 0.02)]

    w, h = t["width"], f["hidden"]
    tower: Spec = [("pos_embed", (1, t["max_len"], w), 0.0, w ** -0.5),
                   ("tok_embed.weight", (t["vocab_size"], w), 0.0, w ** -0.5)]
    tower += norm("ln_embed", w)
    for i in range(t["depth"]):
        b = f"blocks.{i}."
        tower += norm(b + "ln1", w) + dense(b + "attn.qkv", w, 3 * w)
        tower += dense(b + "attn.out", w, w) + norm(b + "ln2", w)
        tower += dense(b + "mlp_in", w, 4 * w) + dense(b + "mlp_out", 4 * w, w)
    tower += norm("ln_final", w)
    fusion: Spec = []
    for key in ("text", "audio", "visual", "temporal"):
        fusion += dense(f"{key}_proj", corpus[key], h)
    for pair in ("tv", "ta", "vu"):
        a = f"attn_{pair}."
        fusion += dense(a + "q", h, h) + dense(a + "k", h, h) + dense(a + "v", h, h)
        fusion += dense(a + "evidence_proj.0", 3, h) + dense(a + "evidence_proj.2", h, 1)
    parts = 15
    if f["use_gnn"]:
        fusion += dense("gnn_proj", g["dim"], h)
        parts += 1
    fusion += dense("fuse_mlp.0", parts * h, 2 * h) + dense("fuse_mlp.3", 2 * h, h)
    fusion += dense("classifier", h, 2)
    ch, nc = c["hidden"], c["num_classes"]
    clf: Spec = [("temperature", (), c["temperature"], 0.02)]
    clf += dense("pre.0", h + (c["aux_dim"] if c["use_aux"] else 0), ch) + dense("pre.3", ch, ch)
    for tree in range(c["node_trees"]):
        p = f"node.trees.{tree}."
        clf += [(p + "leaf_logits", (1 << c["node_depth"], nc), 0.0, 0.5)]
        clf += [(p + f"gates.{k}", (ch,), 0.0, 0.02) for k in range(c["node_depth"])]
        clf += [(p + f"thresh.{k}", (1,), 0.0, 0.02) for k in range(c["node_depth"])]
    clf += dense("bypass", ch, nc)
    gin = sum(width for _, width in g["slices"])
    gnn: Spec = dense("lin1", gin, 2 * g["dim"]) + dense("lin2", 2 * g["dim"], g["dim"])
    return {"fusion": fusion, "clf": clf, "gnn": gnn, "text_tower": tower}


@torch.no_grad()
def graph(cfg: Dict[str, Any], corpus: Dict[str, Any], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_norm (N, N), ax (N, F)) from the corpus's OCR sets and features."""
    sets = corpus["ocr_sets"]
    vocab: Dict[str, int] = {}
    rows, cols = [], []
    for i, s in enumerate(sets):
        for tok in s:
            rows.append(i)
            cols.append(vocab.setdefault(tok, len(vocab)))
    n = len(sets)
    inc = torch.zeros((n, max(1, len(vocab))), dtype=torch.float32, device=device)
    inc[torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device)] = 1.0
    with matmul_precision(False):  # counts, exact in f32
        inter = inc @ inc.t()
    size = inc.sum(dim=1)
    jac = inter / (size[:, None] + size[None, :] - inter + 1e-9)
    adj = (jac >= cfg["gnn"]["overlap_thresh"]).float()
    adj.fill_diagonal_(1.0)
    a_hat = adj + torch.eye(n, device=device)
    d = (a_hat.sum(dim=1) + 1e-9) ** -0.5
    a_norm = a_hat * d[:, None] * d[None, :]
    xg = torch.cat([torch.as_tensor(np.asarray(corpus[key])[:, :width], device=device)
                    for key, width in cfg["gnn"]["slices"]], dim=1).float()
    xg = xg / (xg.norm(dim=1, keepdim=True) + 1e-9)
    with matmul_precision(False):
        ax = a_norm @ xg
    return a_norm, ax


class _Masks:
    def __init__(self, masks: Sequence[torch.Tensor]):
        self.masks, self.i = list(masks), 0

    def apply(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.i >= len(self.masks):
            raise ValueError(f"the step drew {len(self.masks)} dropout masks; the model has more sites")
        keep = self.masks[self.i]
        self.i += 1
        if tuple(keep.shape) != tuple(x.shape):
            raise ValueError(f"dropout mask {self.i - 1} has shape {tuple(keep.shape)}, "
                             f"its site {tuple(x.shape)}")
        return torch.where(keep.to(x.device).bool(), x / (1.0 - rate), torch.zeros_like(x))


def _dense(p, name, x):
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


def _cos01(x, y):
    xn = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
    yn = y / (y.norm(dim=-1, keepdim=True) + 1e-12)
    return 0.5 * ((xn * yn).sum(dim=-1, keepdim=True).clamp(-1.0, 1.0) + 1.0)


def _tower(cfg, p, ids, mask, drop: _Masks):
    t = cfg["tower"]
    w, heads, eps = t["width"], t["heads"], t["ln_eps"]
    b, s = ids.shape
    d = w // heads

    def ln(name, x):
        return F.layer_norm(x, (w,), p[name + ".weight"], p[name + ".bias"], eps)

    x = ln("ln_embed", p["tok_embed.weight"][ids] + p["pos_embed"][:, :s])
    keep = mask.bool()[:, None, None, :]
    for i in range(t["depth"]):
        k = f"blocks.{i}."
        q, kk, v = _dense(p, k + "attn.qkv", ln(k + "ln1", x)).chunk(3, dim=-1)
        q, kk, v = (z.reshape(b, s, heads, d).transpose(1, 2) for z in (q, kk, v))
        scores = (q @ kk.transpose(-1, -2)) / math.sqrt(d)
        a = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1) @ v
        a = _dense(p, k + "attn.out", a.transpose(1, 2).reshape(b, s, w))
        x = x + drop.apply(a, t["dropout"])
        hmid = F.gelu(_dense(p, k + "mlp_in", ln(k + "ln2", x)), approximate="tanh")
        x = x + drop.apply(_dense(p, k + "mlp_out", hmid), t["dropout"])
    x = ln("ln_final", x)
    m = mask[..., None]
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return pooled / (pooled.norm(dim=-1, keepdim=True) + 1e-9)


def _coattn(p, name, x, y, evidence, hidden):
    q, k, v = _dense(p, name + ".q", x), _dense(p, name + ".k", y), _dense(p, name + ".v", y)
    attn = torch.sigmoid((q * k).sum(dim=-1, keepdim=True) / math.sqrt(hidden))
    gate = torch.sigmoid(_dense(p, name + ".evidence_proj.2",
                                F.gelu(_dense(p, name + ".evidence_proj.0", evidence))))
    return gate * (attn * v) + (1.0 - gate) * 0.5 * (x + y)


def _fusion(cfg, p, feats, drop: _Masks):
    f = cfg["fusion"]
    h = f["hidden"]
    t, a = _dense(p, "text_proj", feats["text"]), _dense(p, "audio_proj", feats["audio"])
    v, u = _dense(p, "visual_proj", feats["visual"]), _dense(p, "temporal_proj", feats["temporal"])
    conflict = (1.0 - _cos01(t, v)).detach()
    emotion = torch.tanh(t.abs().mean(dim=-1, keepdim=True)).detach()
    delay = (1.0 - _cos01(t, u)).detach()
    zero = torch.zeros_like(emotion)
    parts = [t, a, v, u, t + a, t * a, (t - a).abs(), t + v, t * v, (t - v).abs(), t + u, v + u,
             _coattn(p, "attn_tv", t, v, torch.cat([conflict, emotion, zero], -1), h),
             _coattn(p, "attn_ta", t, a, torch.cat([emotion, zero, zero], -1), h),
             _coattn(p, "attn_vu", v, u, torch.cat([delay, zero, zero], -1), h)]
    if f["use_gnn"]:
        parts.append(_dense(p, "gnn_proj", feats["gnn"]))
    z = drop.apply(F.gelu(_dense(p, "fuse_mlp.0", torch.cat(parts, dim=-1))), f["dropout"])
    return drop.apply(F.gelu(_dense(p, "fuse_mlp.3", z)), f["dropout"])


def _classifier(cfg, p, fused, aux, drop: _Masks):
    c = cfg["classifier"]
    x = torch.cat([fused, aux], dim=-1) if c["use_aux"] else fused
    z = drop.apply(F.gelu(_dense(p, "pre.0", x)), c["dropout"])
    hid = drop.apply(F.gelu(_dense(p, "pre.3", z)), c["dropout"])
    trees, depth = c["node_trees"], c["node_depth"]
    gates = torch.stack([torch.stack([p[f"node.trees.{t}.gates.{k}"] for k in range(depth)])
                         for t in range(trees)])  # (T, K, F)
    thresh = torch.stack([torch.cat([p[f"node.trees.{t}.thresh.{k}"] for k in range(depth)])
                          for t in range(trees)])  # (T, K)
    leaves = torch.stack([p[f"node.trees.{t}.leaf_logits"] for t in range(trees)])  # (T, L, C)
    choice = torch.einsum("bf,tkf->btk", hid, torch.softmax(gates, dim=-1))
    right = torch.sigmoid(c["node_tau"] * (choice - thresh))  # (B, T, K)
    leaf_ids = torch.arange(1 << depth, device=hid.device)
    goes_right = ((leaf_ids[None, :] >> torch.arange(depth, device=hid.device)[:, None]) & 1).bool()
    prob = torch.where(goes_right, right[..., None], 1.0 - right[..., None]).prod(dim=2)  # (B, T, L)
    per_tree = torch.einsum("btl,tlc->btc", prob, leaves)
    return drop.apply(per_tree, c["node_dropout"]).mean(dim=1) + _dense(p, "bypass", hid)


def step_loss(cfg, p: Dict[str, torch.Tensor], data: Dict[str, torch.Tensor], idx: torch.Tensor,
              mask: torch.Tensor, keep: Sequence[torch.Tensor]) -> torch.Tensor:
    """The masked mean cross-entropy of rows `idx` (`mask` 1 for real rows)
    under the step's dropout masks `keep`; `p` holds every leaf as
    `part.name`."""
    drop = _Masks(keep)
    sub = {k[len("text_tower."):]: v for k, v in p.items() if k.startswith("text_tower.")}
    text = _tower(cfg, sub, data["text_ids"][idx], data["text_mask"][idx], drop)
    g = {k[len("gnn."):]: v for k, v in p.items() if k.startswith("gnn.")}
    hidden = drop.apply(F.gelu(_dense(g, "lin1", data["ax"])), cfg["gnn"]["dropout"])
    gfeat = _dense(g, "lin2", data["a_norm"][idx] @ hidden)
    fp = {k[len("fusion."):]: v for k, v in p.items() if k.startswith("fusion.")}
    feats = {"text": text, "audio": data["audio"][idx], "visual": data["visual"][idx],
             "temporal": data["temporal"][idx], "gnn": gfeat}
    fused = _fusion(cfg, fp, feats, drop)
    cp = {k[len("clf."):]: v for k, v in p.items() if k.startswith("clf.")}
    logits = _classifier(cfg, cp, fused, data["aux"][idx], drop)
    if drop.i != len(drop.masks):
        raise ValueError(f"the step drew {len(drop.masks)} dropout masks; the model used {drop.i}")
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(1, data["labels"][idx][:, None])[:, 0]
    return (ce * mask).sum() / mask.sum().clamp_min(1.0)


def run_steps(cfg: Dict[str, Any], corpus: Dict[str, Any], weights: Tree,
              batches: Sequence[Tuple[np.ndarray, np.ndarray]], masks: Sequence[Sequence[torch.Tensor]],
              steps_per_epoch: int, device, tf32: bool = False) -> Dict[str, Any]:
    """Train `len(batches)` steps from `weights` ({part: {name: tensor}}).

    Returns {"losses": [float], "grad1": {leaf: the first step's gradient
    as the optimizer takes it, clipped}, "params": {leaf: the parameters
    after the last step}}, leaves named `part.name`."""
    o = cfg["optimizer"]
    with matmul_precision(tf32):
        a_norm, ax = graph(cfg, corpus, device)
        data = {"a_norm": a_norm, "ax": ax}
        for key in ("audio", "visual", "temporal", "aux"):
            data[key] = torch.as_tensor(np.asarray(corpus[key]), device=device).float()
        data["labels"] = torch.as_tensor(np.asarray(corpus["labels"]), device=device).long()
        data["text_ids"] = torch.as_tensor(np.asarray(corpus["text_ids"]), device=device).long()
        data["text_mask"] = torch.as_tensor(np.asarray(corpus["text_mask"]), device=device).float()
        p = {f"{part}.{name}": t.detach().clone().float().requires_grad_(True)
             for part, leaves in weights.items() for name, t in leaves.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses: List[float] = []
        grad1: Dict[str, torch.Tensor] = {}
        every = max(1, o["lr_decay_every_epochs"] * steps_per_epoch)
        f32 = np.float32
        for count, ((idx, bmask), keep) in enumerate(zip(batches, masks)):
            i = torch.as_tensor(np.asarray(idx), device=device).long()
            bm = torch.as_tensor(np.asarray(bmask), device=device).float()
            loss = step_loss(cfg, p, data, i, bm, keep)
            grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                g = {k: (gr if gr is not None else torch.zeros_like(p[k]))
                     for k, gr in zip(p, grads)}
                gnorm = torch.sqrt(sum((x * x).sum() for x in g.values()))
                if o["grad_clip"] > 0 and gnorm >= o["grad_clip"]:
                    g = {k: x / gnorm * o["grad_clip"] for k, x in g.items()}
                if count == 0:
                    grad1 = {k: x.clone() for k, x in g.items()}
                lr = float(f32(o["lr"]) * f32(o["lr_decay_rate"]) ** f32(count // every))
                bc1 = 1.0 - o["b1"] ** (count + 1)
                bc2 = 1.0 - o["b2"] ** (count + 1)
                for k in p:
                    m[k] = (1.0 - o["b1"]) * g[k] + o["b1"] * m[k]
                    v2[k] = (1.0 - o["b2"]) * g[k] * g[k] + o["b2"] * v2[k]
                    u = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + o["eps"]) + o["weight_decay"] * p[k]
                    p[k].sub_(lr * u)
    return {"losses": losses, "grad1": grad1,
            "params": {k: x.detach() for k, x in p.items()}}
