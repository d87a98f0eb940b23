"""BERT encoder with HuggingFace weights, its attention on K2 (counterpart of
`ultrafnd_git_tpu/models/bert_flax.py`).

`BertEncoder` is HF's `BertModel` without its pooler: learned word,
position and token-type embeddings, then post-LayerNorm layers (self
attention, exact-erf GELU FFN), `layer_norm_eps` from the config. Its
modules carry HF's names (`embeddings.LayerNorm`,
`encoder.layer.{i}.attention.self.query`, ...), so a `BertModel` or a
task model's `state_dict()` loads as it is (`load_hf_weights` drops the
`bert.` prefix and ignores keys the encoder has no use for, such as the
pooler's). Attention is `kernels.flash_attention.flash_attention` over the
(B, 1, 1, S) padding bias in f32: K2 on a CUDA tensor, which raises on a
head width it was not built for; its plain version on a CPU tensor.
`set_attention(module, plain_attention)` swaps in the plain version on any
device, to hold the kernel against it.

`DeviceBertEncoder` is the text ladder's HF rung on a device
(`bert_flax.py:181-271`): the host tokenizer, then the encoder over chunks
that `plan_chunks` cuts from the request by length, the last hidden state
mean-pooled under the mask, fit to `dim` (truncated or zero-padded) and
L2-normalised (+1e-9), rows in the request's order. The JAX twin pads a
request to power-of-two (batch, sequence) buckets so that XLA compiles few
shapes; this one runs eagerly, where cuBLAS and K2 take any M and S without
a compile, so it sorts the strings by length and pads each chunk only to
its own (rows, sequence), on a grid of 8 rows and 32 tokens. Padded keys
are masked and padded rows dropped, so only the GEMMs' summation order at
another M differs.

That request path is `ChunkedEncoder`, which the device rungs share (this
one and the language-model rung, `models/lfm2.DeviceLfm2Encoder`): a rung
gives its width, its layer FLOPs of a padded chunk (`layer_flops`, which
`plan_chunks` minimises), its fixed cost a chunk, and its forward over one
chunk. `encode_ids` is one `encode.request` span: the plan's `encode.pad`,
one `encode.upload`, an `encode.forward` and an `encode.pool` span a chunk,
one `encode.download`, then `encode.finish` (`utils/spans.py`).

The JAX twin runs K2 on the TPU in its default `mm_dtype=bfloat16`; this
one runs it in f32, as the JAX twin's CPU path and the HF forward do
(ROADMAP.md §3). Its layers (`PackedBertLayer`) run their four products on
the 3xTF32 GEMM (`kernels/gemm_tf32x3`), f32-accurate on the tensor cores,
q/k/v as one; `BertEncoder` and RoBERTa keep the plain linears.
"""
from __future__ import annotations

import functools
import threading
from types import SimpleNamespace
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultrafnd_git_tpu_torch.kernels.flash_attention import (
    flash_attention,
    padding_bias,
    reference_attention,
)
from ultrafnd_git_tpu_torch.kernels.gemm_tf32x3 import linear_tf32x3, split_tf32
from ultrafnd_git_tpu_torch.utils.device import resolve_device, to_device
from ultrafnd_git_tpu_torch.utils.spans import span

Attend = Callable[..., torch.Tensor]


def plain_attention(q, k, v, bias=None) -> torch.Tensor:
    """K2's plain version (its output), on any device."""
    return reference_attention(q, k, v, bias)[0]


def set_attention(module: nn.Module, attend: Attend) -> None:
    """Route every attention of `module` through `attend` (q, k, v, bias)."""
    for m in module.modules():
        if isinstance(m, Attention):
            m.attend = attend


def hf_config(config: Any) -> Any:
    """An HF config object as it is; a mapping of HF's config field names as
    an object with those attributes (no `transformers` needed)."""
    return SimpleNamespace(**config) if isinstance(config, Mapping) else config


def model_parts(model: Any, config: Any = None) -> Tuple[Any, Mapping[str, Any]]:
    """(config, state dict) of an HF model, or of a state dict and its config."""
    if hasattr(model, "state_dict"):
        return hf_config(config if config is not None else model.config), model.state_dict()
    if config is None:
        raise ValueError("a state dict needs its config (an HF config or a mapping)")
    return hf_config(config), model


def load_hf_weights(module: nn.Module, state_dict: Mapping[str, Any], prefix: str) -> None:
    """Load `state_dict` (tensors or numpy arrays, keys with or without
    `prefix`) into `module` as f32. Every key of the module must be there;
    keys it does not have are ignored."""
    sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state_dict.items()}
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{type(module).__name__}: weights missing {missing[:5]}"
                       + (f" and {len(missing) - 5} more" if len(missing) > 5 else ""))
    module.load_state_dict({k: _f32(sd[k]) for k in own})


def _f32(v: Any) -> torch.Tensor:
    return (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(torch.float32)


@torch.no_grad()
def draw_weights_(module: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Seeded weights for a twin run without a checkpoint: every parameter
    N(0, std) from a torch.Generator, a norm's scale 1 + N(0, std)."""
    g = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            draw = torch.randn(p.shape, generator=g) * std
            norm_scale = name == "weight" and isinstance(m, (nn.LayerNorm, nn.GroupNorm))
            p.copy_(draw + 1.0 if norm_scale else draw)
    return module


def heads_first(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, W) -> contiguous (B, heads, S, W / heads)."""
    b, s, w = t.shape
    return t.view(b, s, heads, w // heads).transpose(1, 2).contiguous()


def heads_last(t: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H * D)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


class Attention(nn.Module):
    """Base of the twins' self-attentions: `attend` is the attention call."""

    attend: Attend = staticmethod(flash_attention)


class BertSelfAttention(Attention):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        q, k, v = (heads_first(p(x), self.heads) for p in (self.query, self.key, self.value))
        return heads_last(self.attend(q, k, v, bias))


class _DenseNorm(nn.Module):
    """HF's `*Output` blocks: LayerNorm(residual + dense(h))."""

    def __init__(self, d_in: int, width: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, width)
        self.LayerNorm = nn.LayerNorm(width, eps=eps)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dense(h))


class BertAttention(nn.Module):
    def __init__(self, width: int, heads: int, eps: float):
        super().__init__()
        self.self = BertSelfAttention(width, heads)
        self.output = _DenseNorm(width, width, eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class _Intermediate(nn.Module):
    def __init__(self, width: int, intermediate: int):
        super().__init__()
        self.dense = nn.Linear(width, intermediate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # HF "gelu": the exact erf form


class BertLayer(nn.Module):
    """One HF BERT layer: post-LN self-attention, post-LN FFN."""

    def __init__(self, width: int, heads: int, intermediate: int, eps: float = 1e-12):
        super().__init__()
        self.attention = BertAttention(width, heads, eps)
        self.intermediate = _Intermediate(width, intermediate)
        self.output = _DenseNorm(intermediate, width, eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class Tf32x3Linear(nn.Module):
    """One or more HF linears of a layer as one 3xTF32 product
    (`kernels/gemm_tf32x3.linear_tf32x3`): their weights concatenated along
    the output and split once, at construction, into W_hi and W_lo, with
    their biases; all three non-persistent buffers, so the layer's state
    dict keeps the HF keys of the linears it was made from."""

    def __init__(self, *linears: nn.Linear, gelu: bool = False):
        super().__init__()
        self.gelu = gelu
        hi, lo = split_tf32(torch.cat([lin.weight.detach() for lin in linears]))
        self.register_buffer("w_hi", hi, persistent=False)
        self.register_buffer("w_lo", lo, persistent=False)
        self.register_buffer("bias", torch.cat([lin.bias.detach() for lin in linears]),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_tf32x3(x, self.w_hi, self.w_lo, self.bias, gelu=self.gelu)


class PackedBertLayer(BertLayer):
    """`BertLayer` with its four products in 3xTF32 (`DeviceBertEncoder`'s
    layers): query, key and value as one product of N = 3 W (q, k and v
    views of its output), the attention output, the intermediate with the
    GELU in its epilogue, and the output. The HF linears stay as the
    layer's children, for its state dict; `pack_()` makes the products from
    their weights as they then are (after loading, on the layer's device)."""

    def pack_(self) -> None:
        att = self.attention.self
        self.qkv = Tf32x3Linear(att.query, att.key, att.value)
        self.attn_out = Tf32x3Linear(self.attention.output.dense)
        self.ffn_in = Tf32x3Linear(self.intermediate.dense, gelu=True)
        self.ffn_out = Tf32x3Linear(self.output.dense)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        att = self.attention.self
        q, k, v = (heads_first(t, att.heads) for t in self.qkv(x).chunk(3, dim=-1))
        h = heads_last(att.attend(q, k, v, bias))
        x = self.attention.output.LayerNorm(x + self.attn_out(h))
        return self.output.LayerNorm(x + self.ffn_out(self.ffn_in(x)))


class BertLayers(nn.Module):
    """HF's `encoder`: `layer.{i}`, of class `layer`."""

    def __init__(self, depth: int, width: int, heads: int, intermediate: int, eps: float,
                 layer: type = BertLayer):
        super().__init__()
        self.layer = nn.ModuleList(layer(width, heads, intermediate, eps) for _ in range(depth))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        bias = padding_bias(mask)
        for layer in self.layer:
            x = layer(x, bias)
        return x


class BertEmbeddings(nn.Module):
    def __init__(self, vocab: int, width: int, positions: int, type_vocab: int, eps: float):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, width)
        self.position_embeddings = nn.Embedding(positions, width)
        self.token_type_embeddings = nn.Embedding(type_vocab, width)
        self.LayerNorm = nn.LayerNorm(width, eps=eps)

    def forward(self, ids: torch.Tensor, type_ids: torch.Tensor,
                pos_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pos_ids is None:
            pos_ids = torch.arange(ids.shape[1], device=ids.device)[None]
        return self.LayerNorm(self.word_embeddings(ids) + self.position_embeddings(pos_ids)
                              + self.token_type_embeddings(type_ids))


class BertEncoder(nn.Module):
    """HF `BertModel` without the pooler: ids, mask -> last hidden state."""

    def __init__(self, width: int = 768, depth: int = 12, heads: int = 12,
                 intermediate: int = 3072, vocab_size: int = 30522, max_positions: int = 512,
                 type_vocab: int = 2, ln_eps: float = 1e-12, layer: type = BertLayer):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, width, max_positions, type_vocab, ln_eps)
        self.encoder = BertLayers(depth, width, heads, intermediate, ln_eps, layer)

    @classmethod
    def from_config(cls, config: Any, layer: type = BertLayer) -> "BertEncoder":
        cfg = hf_config(config)
        return cls(width=cfg.hidden_size, depth=cfg.num_hidden_layers,
                   heads=cfg.num_attention_heads, intermediate=cfg.intermediate_size,
                   vocab_size=cfg.vocab_size, max_positions=cfg.max_position_embeddings,
                   type_vocab=cfg.type_vocab_size,
                   ln_eps=float(getattr(cfg, "layer_norm_eps", 1e-12)), layer=layer)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids (B, S) int, mask (B, S) 1/0 -> (B, S, width) f32."""
        if type_ids is None:
            type_ids = torch.zeros_like(ids)
        return self.encoder(self.embeddings(ids, type_ids), mask)


def seq_bucket(n: int, cap: int, smallest: int = 32) -> int:
    """The power-of-two bucket (from `smallest`) that holds n, at most cap."""
    b = smallest
    while b < n:
        b *= 2
    return min(b, cap)


def pad_to(a: np.ndarray, rows: int, cols: int, value=0) -> np.ndarray:
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])), constant_values=value)


def fit_dim(vecs: np.ndarray, dim: int) -> np.ndarray:
    """Truncate to, or zero-pad up to, `dim` columns."""
    if vecs.shape[-1] > dim:
        return vecs[..., :dim]
    if vecs.shape[-1] < dim:
        return np.pad(vecs, ((0, 0), (0, dim - vecs.shape[-1])))
    return vecs


def l2_rows(vecs: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    return (vecs / (np.linalg.norm(vecs, axis=-1, keepdims=True) + eps)).astype(np.float32)


def tokenize(tokenizer, texts: List[str], max_length: int,
             padding: Any = True) -> Tuple[np.ndarray, np.ndarray]:
    """(ids int64, mask f32) of an HF tokenizer call on `texts`."""
    enc = tokenizer(texts, padding=padding, truncation=True, max_length=max_length,
                    return_tensors="np")
    return (np.asarray(enc["input_ids"], np.int64),
            np.asarray(enc["attention_mask"], np.float32))


# The planner's grid: a chunk's rows are padded to a multiple of ROW_STEP (at
# most batch_size), its sequence to a multiple of SEQ_STEP (at most max_length).
ROW_STEP = 8
SEQ_STEP = 32
# A chunk's fixed cost to the planner, a layer, in FLOPs at the rate of the
# chunk's own work: its launches, and the lower GEMM efficiency at small M.
# Measured at bert-base's widths on an H100 80GB HBM3 (700 W), f32, TF32 off,
# by `scripts/bert_chunk_cost.py`: a chunk's time at 104 (rows, sequence)
# points from (8, 32) to (256, 256), fit as FLOPs / rate + fixed, read 2.8 to
# 4.6 ms a chunk at 43 to 45 TFLOP/s in two runs, 1.0e10 to 1.7e10 FLOPs a
# layer. The top of that range: below it the planner cuts full (64, 256)
# chunks of long strings into two of 32 rows, which ran 6 ms slower than the
# one (the GEMMs' waves, which a FLOP count does not see).
CHUNK_LAYER_FLOPS = 1.7e10

# Counts since import (or since a caller reset them): forward calls of the
# encoder, and the rows x sequence they ran against the mask's sum. Added to
# under a lock: featurize threads encode while others do.
encode_chunks = 0
encode_padded_slots = 0
encode_real_slots = 0
_COUNT_LOCK = threading.Lock()


def _round_up(n, step):
    return -(-n // step) * step


def string_lengths(mask: np.ndarray) -> np.ndarray:
    """Each row's real length: one past its last unmasked position (0 for a
    row with none)."""
    on = np.asarray(mask) > 0
    return (on * np.arange(1, on.shape[1] + 1)).max(axis=1, initial=0)


def chunk_flops(rows: int, seq: int, width: int, intermediate: int) -> float:
    """A layer's FLOPs on a chunk padded to (rows, seq): the projections and
    the feed-forward, 2 M W (4 W + 2 I) at M = rows x seq, and Q K^T and P V,
    4 rows S^2 W."""
    m = rows * seq
    return 2.0 * m * width * (4 * width + 2 * intermediate) + 4.0 * m * seq * width


def bert_layer_flops(width: int, intermediate: int) -> Callable[[int, int], float]:
    """`chunk_flops` at a BERT's widths, as the planner takes it."""
    return functools.partial(chunk_flops, width=width, intermediate=intermediate)


def plan_chunks(lengths: np.ndarray, batch_size: int, max_length: int,
                layer_flops: Callable[[int, int], float], chunk_cost: float = CHUNK_LAYER_FLOPS
                ) -> List[Tuple[np.ndarray, int, int]]:
    """The chunks of one request: [(the request's rows it holds, padded rows,
    padded sequence)], rows shortest first.

    The strings are sorted by length (stably) and cut into contiguous chunks
    of at most `batch_size` rows, each padded to rows on ROW_STEP's grid and
    to its own longest string on SEQ_STEP's (at most `max_length`). The cuts
    minimise `layer_flops(rows, seq)` (the model's FLOPs of a layer on a
    chunk so padded; `bert_layer_flops` for a BERT) plus `chunk_cost` a
    chunk: strings of one rounded sequence form a group, a DP over adjacent
    groups picks the runs of groups that share a chunk, and a run of more
    than `batch_size` strings is split evenly."""
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    if n == 0:
        return []
    order = np.argsort(lengths, kind="stable")
    need = np.minimum(_round_up(np.maximum(lengths[order], 1), SEQ_STEP), max_length)
    seqs, starts = np.unique(need, return_index=True)
    edges = starts.tolist() + [n]
    groups = len(seqs)

    def pieces(lo, hi):  # a run split evenly into chunks of at most batch_size
        k = -(-(hi - lo) // batch_size)
        return [lo + j * (hi - lo) // k for j in range(k + 1)]

    best, back = [0.0] + [float("inf")] * groups, [0] * (groups + 1)
    for b in range(1, groups + 1):
        seq = int(seqs[b - 1])
        for a in range(b):
            count = edges[b] - edges[a]
            k = -(-count // batch_size)
            rows = min(_round_up(-(-count // k), ROW_STEP), batch_size)
            cost = best[a] + k * (layer_flops(rows, seq) + chunk_cost)
            if cost < best[b]:
                best[b], back[b] = cost, a
    runs, b = [], groups
    while b:
        runs.append((edges[back[b]], edges[b]))
        b = back[b]
    chunks = []
    for lo, hi in reversed(runs):
        cuts = pieces(lo, hi)
        for s, e in zip(cuts, cuts[1:]):
            chunks.append((order[s:e], min(_round_up(e - s, ROW_STEP), batch_size),
                           int(need[e - 1])))
    return chunks


class ChunkedEncoder:
    """The request path of a device rung: strings -> (N, dim) L2-normalised
    rows, the mean of each string's last hidden state under its mask.

    A request is planned on the host (`plan_chunks`): its strings sorted by
    length and cut into chunks of at most `batch_size` rows, each padded to
    its own (rows, sequence) on a grid of 8 rows and 32 tokens. The chunks
    go up in one copy, each runs `forward` and is mean-pooled under its
    mask (in f32), its rows land in one (N, width) buffer in the request's
    order, and the buffer comes down in one copy. The chunks run longest
    first: the device works through the longest while the host launches
    the shorter ones, whose launches take longer than their device time in
    the LM rung (PERF.md §6).

    A subclass sets `device`, `dim`, `max_length`, `batch_size`, `width`,
    `tok`, `layer_flops` and `chunk_cost`, and gives `forward(ids, mask,
    real)` of one chunk, (rows, seq, width). With `wants_real` the upload
    also holds each chunk's real positions (flat indices into the chunk, in
    order), made on the host, and `real` is that chunk's slice (else None).
    """

    device: torch.device
    dim: int
    max_length: int
    batch_size: int
    width: int
    tok: Any = None
    layer_flops: Callable[[int, int], float]
    chunk_cost: float
    wants_real = False

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                real: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def _padded(self, ids: np.ndarray, mask: np.ndarray):
        """The request's plan, and its chunks laid end to end on the host:
        (plan, ids with each chunk's destination rows after them and then,
        with `wants_real`, each chunk's real positions; mask; the real
        positions' count of each chunk)."""
        global encode_chunks, encode_padded_slots, encode_real_slots
        lengths = string_lengths(mask)
        if lengths.size and lengths.max() > self.max_length:
            raise ValueError(f"a string of {lengths.max()} tokens is over max_length "
                             f"{self.max_length}")
        plan = plan_chunks(lengths, self.batch_size, self.max_length, self.layer_flops,
                           self.chunk_cost)
        slots = sum(rows * seq for _, rows, seq in plan)
        flat_ids = np.zeros(slots + len(ids), np.int64)
        flat_mask = np.zeros(slots, np.float32)
        order = np.concatenate([rows_of for rows_of, _, _ in plan] or [lengths[:0]])
        flat_ids[slots:] = order
        ids, mask = ids[order], mask[order]  # the chunks are runs of this order
        at = first = 0
        for rows_of, rows, seq in plan:
            last, cols = first + len(rows_of), min(seq, ids.shape[1])
            for flat, src in ((flat_ids, ids), (flat_mask, mask)):
                flat[at:at + rows * seq].reshape(rows, seq)[:len(rows_of), :cols] = \
                    src[first:last, :cols]
            at, first = at + rows * seq, last
        counts = []
        if self.wants_real:
            at, parts = 0, [flat_ids]
            for _, rows, seq in plan:
                parts.append(np.flatnonzero(flat_mask[at:at + rows * seq]))
                counts.append(len(parts[-1]))
                at += rows * seq
            flat_ids = np.concatenate(parts)
        with _COUNT_LOCK:
            encode_chunks += len(plan)
            encode_padded_slots += slots
            encode_real_slots += int(np.sum(mask, dtype=np.float64))
        return plan, flat_ids, flat_mask, counts

    @torch.inference_mode()
    def encode_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Token ids (N, L) and their 1/0 mask -> (N, dim): the planned
        chunks, one upload and one download (every string at most
        `max_length` tokens)."""
        with span("encode.request"):
            with span("encode.pad"):
                plan, flat_ids, flat_mask, counts = self._padded(np.asarray(ids),
                                                                 np.asarray(mask))
            with span("encode.upload"):
                ids_t = to_device(torch.from_numpy(flat_ids), self.device)
                mask_t = to_device(torch.from_numpy(flat_mask), self.device)
            pooled = torch.empty((len(ids), self.width), dtype=torch.float32,
                                 device=self.device)
            starts, at, dest, real_at = [], 0, len(flat_mask), len(flat_mask) + len(ids)
            for c, (rows_of, rows, seq) in enumerate(plan):  # each chunk's slices of the upload
                starts.append((at, dest, real_at))
                at, dest = at + rows * seq, dest + len(rows_of)
                real_at += counts[c] if self.wants_real else 0
            for c in reversed(range(len(plan))):  # the longest chunk first
                (rows_of, rows, seq), (at, dest, real_at) = plan[c], starts[c]
                chunk_ids = ids_t[at:at + rows * seq].view(rows, seq)
                chunk_mask = mask_t[at:at + rows * seq].view(rows, seq)
                real = ids_t[real_at:real_at + counts[c]] if self.wants_real else None
                with span("encode.forward"):
                    hidden = self.forward(chunk_ids, chunk_mask, real)
                with span("encode.pool"):
                    m = chunk_mask[:len(rows_of), :, None]
                    rep = (hidden[:len(rows_of)] * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)
                    pooled.index_copy_(0, ids_t[dest:dest + len(rows_of)], rep)
            with span("encode.download"):
                out = pooled.cpu().numpy()
            with span("encode.finish"):
                return l2_rows(fit_dim(out, self.dim))

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Strings -> (N, dim): tokenized, then planned as `encode_ids`."""
        if not len(texts):
            return np.zeros((0, self.dim), np.float32)
        return self.encode_ids(*tokenize(self.tok, list(texts), self.max_length))


class DeviceBertEncoder(ChunkedEncoder):
    """HF BERT weights in a `BertEncoder` on `device` (cuda by default;
    raises without a GPU), over `ChunkedEncoder`'s request path.

    `model` is an HF BERT model, or a state dict (`BertModel` keys, with or
    without `bert.`) with its `config` (an HF config or a mapping of its
    fields). `tokenizer` is an HF tokenizer (or any callable with its call
    contract and `return_tensors="np"`). A chunk's forward is
    `self.module(ids, mask)`, in f32, its layers `PackedBertLayer`s: the
    four products of a layer in 3xTF32 (`kernels/gemm_tf32x3`; the plain
    f32 linear on a CPU tensor), q/k/v as one. The module keeps
    `BertEncoder`'s state-dict keys.
    """

    @property
    def chunk_cost(self) -> float:
        return CHUNK_LAYER_FLOPS  # read at each plan

    def __init__(self, model: Any, tokenizer: Any, dim: int = 768, max_length: int = 256,
                 batch_size: int = 256, device: str = "cuda", config: Any = None):
        cfg, sd = model_parts(model, config)
        self.device = resolve_device(device)
        self.dim, self.max_length, self.batch_size = int(dim), int(max_length), int(batch_size)
        self.width, self.intermediate = int(cfg.hidden_size), int(cfg.intermediate_size)
        self.layer_flops = bert_layer_flops(self.width, self.intermediate)
        self.tok = tokenizer
        self.module = BertEncoder.from_config(cfg, layer=PackedBertLayer)
        load_hf_weights(self.module, sd, "bert.")
        self.module.to(self.device).eval()
        for layer in self.module.encoder.layer:
            layer.pack_()

    def forward(self, ids, mask, real=None):
        return self.module(ids, mask)
