"""The text ladder's language-model rung (`models/lfm2.py`) on the CPU: the
port's LFM2-MoE against the plain reference (`tests/_lfm2_reference.py`) at
a small size in f32, its expert layer against a per-token loop, the causal
attention's plain versions against a masked softmax, the shared request
path's planner against its BERT plans, and the ladder's opt-in.

Tolerances: hidden states and rows 1e-5 (f32 on both sides, another
summation order); the per-token loop 1e-5."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _lfm2_reference import SMALL, draw, encode, hidden
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
from ultrafnd_git_tpu_torch.models import bert, encoders, lfm2
from ultrafnd_git_tpu_torch.utils import spans

TOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    return draw(SMALL, seed=3)


@pytest.fixture(scope="module")
def model(weights):
    return lfm2.build(SMALL, weights, torch.device("cpu"), torch.float32)


def _batch(lengths, seed=0, vocab=300):
    rng = np.random.default_rng(seed)
    s = int(max(lengths))
    mask = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    ids = (rng.integers(3, vocab, mask.shape) * mask).astype(np.int64)
    return torch.from_numpy(ids), torch.from_numpy(mask)


@pytest.mark.parametrize("with_real", [False, True], ids=["every_position", "real_positions"])
def test_model_matches_the_reference(model, weights, with_real):
    """Right-padded strings of 1 to 37 tokens: every real position's last
    hidden state within 1e-5 of the reference, whether the expert layers
    take every position or the real ones alone."""
    ids, mask = _batch([17, 5, 37, 1, 30])
    real = mask.flatten().nonzero()[:, 0] if with_real else None
    with torch.no_grad():
        got = model(ids, mask, real)
    want = hidden(SMALL, weights, ids, mask)
    keep = mask.bool()
    assert float((got - want)[keep].abs().max()) <= TOL * float(want[keep].abs().max())


def test_mixers_are_causal(model):
    """Changing the last token leaves every earlier position's hidden state
    (within 1e-5: the expert products run over a batch of another makeup)
    and moves the last: the conv and the attention read only the positions
    before."""
    ids, mask = _batch([24, 24], seed=1)
    other = ids.clone()
    other[:, -1] = (other[:, -1] + 7) % 300
    with torch.no_grad():
        a, b = model(ids, mask), model(other, mask)
    scale = float(a.abs().max())
    assert float((a[:, :-1] - b[:, :-1]).abs().max()) <= TOL * scale
    assert float((a[:, -1] - b[:, -1]).abs().max()) > 1e-2 * scale


def test_encoder_rows_match_the_reference(weights):
    """`DeviceLfm2Encoder.encode_ids` (planned chunks, real positions,
    pooled, fit, L2-normalised) against the reference's rows."""
    enc = lfm2.DeviceLfm2Encoder(weights, None, SMALL, dim=96, max_length=48, batch_size=8,
                                 device="cpu", dtype=torch.float32)
    lengths = np.random.default_rng(2).integers(1, 49, 21)
    ids, mask = _batch(lengths, seed=2)
    before = lfm2.moe_counters()
    unrecorded = enc.encode_ids(ids.numpy(), mask.numpy())
    assert lfm2.moe_counters() == before  # counted only while spans are recorded
    with spans.recording():
        got = enc.encode_ids(ids.numpy(), mask.numpy())
    after = lfm2.moe_counters()
    want = encode(SMALL, weights, ids, mask, 96).numpy()
    assert got.shape == (21, 96)
    assert np.abs(got - want).max() <= TOL
    assert np.array_equal(got, unrecorded)
    moe_layers = SMALL["num_hidden_layers"] - SMALL["num_dense_layers"]
    rows = after["rows"] - before["rows"]
    assert rows == moe_layers * 2 * int(lengths.sum())
    calls = after["calls"] - before["calls"]
    assert calls >= moe_layers
    # each call's busiest expert holds at least the mean expert's rows
    busiest = after["busiest_rows"] - before["busiest_rows"]
    assert rows / SMALL["num_experts"] <= busiest <= rows


def _per_token(moe, x):
    """Each token alone: its scores, its top-k of scores + bias, its gated
    SwiGLU experts summed."""
    inner = moe.w2.shape[2]
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        scores = torch.sigmoid(x[t] @ moe.gate.weight.t())
        top = torch.topk(scores + moe.expert_bias, moe.top_k).indices
        gates = scores[top] / (scores[top].sum() + 1e-6)
        for g, e in zip(gates, top.tolist()):
            w1, w3 = moe.w13[e, :inner], moe.w13[e, inner:]
            out[t] += g * ((torch.nn.functional.silu(x[t] @ w1.t()) * (x[t] @ w3.t()))
                           @ moe.w2[e].t())
    return out


def test_expert_layer_matches_a_per_token_loop(model):
    """The sorted, grouped expert layer against a loop over tokens, with the
    bias choosing: a token whose top-k without the bias differs from its
    top-k with it takes the bias's experts."""
    moe = model.layers[-1].feed_forward
    x = torch.randn(40, SMALL["hidden_size"], generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got, want = moe(x), _per_token(moe, x)
        selected, _ = moe.route(x)
        scores = torch.sigmoid(x @ moe.gate.weight.t())
        unbiased = torch.topk(scores, moe.top_k).indices
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    flipped = [t for t in range(40) if set(selected[t].tolist()) != set(unbiased[t].tolist())]
    assert flipped, "the expert bias chose no token's experts"
    biased = torch.topk(scores + moe.expert_bias, moe.top_k).indices
    assert all(set(selected[t].tolist()) == set(biased[t].tolist()) for t in flipped)


def test_a_large_bias_flips_a_tokens_choice(model):
    """One expert's bias raised above every score: every token routes to
    it, and the layer's output moves with it."""
    moe = model.layers[-1].feed_forward
    x = torch.randn(6, SMALL["hidden_size"], generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        before = moe(x)
        old = moe.expert_bias.clone()
        try:
            moe.expert_bias[5] = 10.0
            selected, _ = moe.route(x)
            after, want = moe(x), _per_token(moe, x)
        finally:
            moe.expert_bias.copy_(old)
    assert bool((selected == 5).any(dim=1).all())
    assert float((after - want).abs().max()) <= TOL * float(want.abs().max())
    assert not torch.allclose(before, after)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_causal_attention_matches_a_masked_softmax(dtype):
    """The plain causal versions against softmax over the keys at or before
    each query; a right-padded row's real positions are what the row alone,
    unpadded, gives."""
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 3, 40, 64, generator=g).to(dtype) for _ in range(3))
    mask = torch.ones(2, 40)
    mask[1, 25:] = 0
    bias = fa.padding_bias(mask, dtype)
    out = lfm2.plain_causal_attention(q, k, v, bias)
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = qf @ kf.transpose(-1, -2) / 8.0 + bias.float()
    s = s.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.softmax(s, dim=-1) @ vf
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    assert float((out.float() - want).abs().max()) <= tol * float(want.abs().max())
    alone = lfm2.plain_causal_attention(q[1:, :, :25].contiguous(), k[1:, :, :25].contiguous(),
                                        v[1:, :, :25].contiguous(),
                                        fa.padding_bias(torch.ones(1, 25), dtype))
    assert torch.equal(out[1:, :, :25], alone)


def _parent_plan(lengths, batch_size, max_length, width, intermediate, chunk_cost):
    """The planner as it was before it took a FLOPs function (BERT's
    widths built in), kept to hold the BERT plans to."""
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    if n == 0:
        return []
    order = np.argsort(lengths, kind="stable")
    step, seq_step = bert.ROW_STEP, bert.SEQ_STEP
    up = lambda a, s: -(-a // s) * s  # noqa: E731
    need = np.minimum(up(np.maximum(lengths[order], 1), seq_step), max_length)
    seqs, starts = np.unique(need, return_index=True)
    edges = starts.tolist() + [n]
    groups = len(seqs)
    best, back = [0.0] + [float("inf")] * groups, [0] * (groups + 1)
    for b in range(1, groups + 1):
        seq = int(seqs[b - 1])
        for a in range(b):
            count = edges[b] - edges[a]
            k = -(-count // batch_size)
            rows = min(up(-(-count // k), step), batch_size)
            m = rows * seq
            flops = 2.0 * m * width * (4 * width + 2 * intermediate) + 4.0 * m * seq * width
            cost = best[a] + k * (flops + chunk_cost)
            if cost < best[b]:
                best[b], back[b] = cost, a
    runs, b = [], groups
    while b:
        runs.append((edges[back[b]], edges[b]))
        b = back[b]
    chunks = []
    for lo, hi in reversed(runs):
        k = -(-(hi - lo) // batch_size)
        cuts = [lo + j * (hi - lo) // k for j in range(k + 1)]
        for s, e in zip(cuts, cuts[1:]):
            chunks.append((order[s:e], min(up(e - s, step), batch_size), int(need[e - 1])))
    return chunks


@pytest.mark.parametrize("traffic", ["encode_fields_r12", "encode_ocr_s256"])
def test_bert_plans_are_unchanged(traffic):
    """`plan_chunks` with BERT's layer FLOPs gives the plans it gave before
    it took the FLOPs as a function, on the BERT cells' request pools."""
    from portbench.traffic import request_lengths

    spec = json.loads((REPO / "portbench" / "traffic" / f"{traffic}.json").read_text())
    for lengths in request_lengths(spec, 256)[:48]:
        got = bert.plan_chunks(lengths, 256, 256, bert.bert_layer_flops(768, 3072),
                               bert.CHUNK_LAYER_FLOPS)
        want = _parent_plan(lengths, 256, 256, 768, 3072, bert.CHUNK_LAYER_FLOPS)
        assert len(got) == len(want)
        for (a, ra, sa), (b, rb, sb) in zip(got, want):
            assert (ra, sa) == (rb, sb) and np.array_equal(a, b)


class _Words:
    """A tokenizer's call contract over whitespace words (id = 3 + len)."""

    def __call__(self, texts, padding=True, truncation=True, max_length=64, return_tensors="np"):
        rows = [[1] + [3 + len(w) for w in t.split()][:max_length - 1] for t in texts]
        width = max(len(r) for r in rows)
        ids = np.zeros((len(rows), width), np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)], mask[i, :len(r)] = r, 1
        return {"input_ids": ids, "attention_mask": mask}


def test_ladder_takes_the_lm_rung_only_under_its_opt_in(weights, monkeypatch, tmp_path):
    """With `ULTRAFND_TEXT_LM` unset the ladder and `text_rung()` are as
    before; set, the ladder encodes through `DeviceLfm2Encoder` (its files
    read at first use) and `text_rung()` names it."""
    monkeypatch.delenv(encoders.TEXT_LM, raising=False)
    assert encoders.text_rung() is None or not encoders.text_rung().startswith("lm:")
    plain = encoders.TextFieldEncoder(dim=96, device="cpu")
    assert plain._lm_path is None

    made = []

    def from_files(path, **kwargs):
        made.append(path)
        return lfm2.DeviceLfm2Encoder(weights, _Words(), SMALL, dtype=torch.float32,
                                      **{**kwargs, "device": "cpu"})

    monkeypatch.setattr(lfm2.DeviceLfm2Encoder, "from_files", staticmethod(from_files))
    monkeypatch.setenv(encoders.TEXT_LM, str(tmp_path))
    assert encoders.text_rung() == f"lm:{tmp_path.resolve()}:device"
    enc = encoders.TextFieldEncoder(dim=96, max_length=32, device="cpu")
    texts = ["fake news video", "", "a scary alien warning title"]
    rows = enc.encode_batch(texts)
    assert made == [str(tmp_path)]
    assert rows.shape == (3, 96) and not rows[1].any()
    ids = _Words()([texts[0], texts[2]], max_length=32)
    want = encode(SMALL, weights, torch.from_numpy(ids["input_ids"]),
                  torch.from_numpy(ids["attention_mask"]).float(), 96).numpy()
    assert np.abs(rows[[0, 2]] - want).max() <= TOL


def test_lm_rung_reads_the_published_files(weights, tmp_path):
    """`from_files`: config.json, a safetensors shard in the published key
    names (with `model.` and an LM head the rung ignores) and the
    tokenizer's files; a missing tensor raises."""
    transformers = pytest.importorskip("transformers")
    from safetensors.torch import save_file

    tokenizers = pytest.importorskip("tokenizers")
    vocab = {"<|pad|>": 0, "<|startoftext|>": 1, "[UNK]": 2, "fake": 3, "news": 4, "video": 5}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<|pad|>",
                                         unk_token="[UNK]").save_pretrained(tmp_path)
    cfg = {k: v for k, v in SMALL.items() if k != "weights"}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    state = {"model." + k: v.contiguous() for k, v in weights.items()}
    state["lm_head.weight"] = torch.zeros(SMALL["vocab_size"], SMALL["hidden_size"])
    save_file(state, str(tmp_path / "model.safetensors"))
    enc = lfm2.DeviceLfm2Encoder.from_files(str(tmp_path), dim=96, device="cpu",
                                            dtype=torch.float32)
    rows = enc.encode_batch(["fake news", "video fake news news"])
    assert rows.shape == (2, 96)
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, atol=1e-5)
    del state["model.layers.1.feed_forward.experts.0.w3.weight"]
    save_file(state, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="experts.0.w3"):
        lfm2.DeviceLfm2Encoder.from_files(str(tmp_path), device="cpu", dtype=torch.float32)
