"""PyTorch port, the BERT twin (`models/bert.py`) against the JAX package's
(`models/bert_flax.py`) and the `transformers` forward.

Hermetic, as `tests/test_bert_flax.py`: a small randomly initialised
`transformers.BertModel` (no download) whose weights go into the port's
`BertEncoder` as its `state_dict()` is, into the Flax twin through
`torch_bert_to_flax_params`, and back into the port through
`utils/transfer.bert_state_dict`. On the CPU the port's attention is K2's
plain version and the Flax twin's the XLA reference: both exact f32.

Tolerance: hidden states and encodings 1e-4 (the JAX test's); the planned
chunks against the whole request in one power-of-two bucket 1e-6 (f32
round-off of GEMMs at another M).
"""
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")  # keep TensorFlow out of this process
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from ultrafnd_git_tpu.models.bert_flax import BertEncoderFlax  # noqa: E402
from ultrafnd_git_tpu.models.bert_flax import DeviceBertEncoder as JaxDeviceBert  # noqa: E402
from ultrafnd_git_tpu.models.bert_flax import torch_bert_to_flax_params  # noqa: E402
from ultrafnd_git_tpu_torch.models import bert as port_bert  # noqa: E402
from ultrafnd_git_tpu_torch.models.bert import (  # noqa: E402
    BertEncoder,
    DeviceBertEncoder,
    load_hf_weights,
    bert_layer_flops,
    plan_chunks,
    seq_bucket,
)
from ultrafnd_git_tpu_torch.utils.transfer import bert_state_dict  # noqa: E402

VOCAB = 97
TOL = dict(atol=1e-4, rtol=1e-4)
TEXTS = ["hello world", "fake news video title", "真 假 comment", "", "title " * 40]
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "fake", "news", "video", "title",
         "comment", "真", "假"]


@pytest.fixture(scope="module")
def bert():
    cfg = transformers.BertConfig(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=128,
                                  max_position_embeddings=48, type_vocab_size=2,
                                  hidden_act="gelu")
    torch.manual_seed(0)
    return transformers.BertModel(cfg).eval()


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    vocab = tmp_path_factory.mktemp("bert_vocab") / "vocab.txt"
    vocab.write_text("\n".join(WORDS), encoding="utf-8")
    return transformers.BertTokenizer(str(vocab))


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (3, 17))
    mask = np.ones((3, 17), np.float32)
    mask[0, 12:] = 0.0
    mask[2, 5:] = 0.0
    return ids, mask


def _port(state_dict, cfg) -> BertEncoder:
    module = BertEncoder.from_config(cfg)
    load_hf_weights(module, state_dict, "bert.")
    return module.eval()


def _run(module, ids, mask) -> np.ndarray:
    with torch.inference_mode():
        return module(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


def test_twin_matches_transformers_and_the_jax_twin(bert):
    ids, mask = _batch()
    with torch.inference_mode():
        ref = bert(input_ids=torch.from_numpy(ids),
                   attention_mask=torch.from_numpy(mask).long()).last_hidden_state.numpy()
    got = _run(_port(bert.state_dict(), bert.config), ids, mask)
    flax = BertEncoderFlax(width=64, depth=2, heads=4, intermediate=128, vocab_size=VOCAB,
                           max_positions=48, type_vocab=2, attention_backend="xla")
    params = torch_bert_to_flax_params(bert.state_dict(), depth=2)
    jax_out = np.asarray(flax.apply({"params": params}, jnp.asarray(ids, jnp.int32),
                                    jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jax_out, **TOL)


def test_jax_params_cross_the_bridge_exactly(bert):
    """bert_state_dict inverts torch_bert_to_flax_params key for key."""
    params = torch_bert_to_flax_params(bert.state_dict(), depth=2)
    sd = bert_state_dict(params)
    own = BertEncoder.from_config(bert.config).state_dict()
    assert set(sd) == set(own)
    hf = bert.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(v, hf[k].numpy(), err_msg=k)


def test_prefixed_and_task_model_state_dicts_load(bert):
    """`bert.`-prefixed keys (a task model's) load, extra keys (pooler, a
    head) are ignored, and a missing key raises."""
    ids, mask = _batch()
    ref = _run(_port(bert.state_dict(), bert.config), ids, mask)
    prefixed = {f"bert.{k}": v for k, v in bert.state_dict().items()}
    prefixed["classifier.weight"] = torch.zeros(2, 64)
    np.testing.assert_array_equal(_run(_port(prefixed, bert.config), ids, mask), ref)
    partial = dict(bert.state_dict())
    partial.pop("encoder.layer.1.output.dense.bias")
    with pytest.raises(KeyError, match="encoder.layer.1.output.dense.bias"):
        _port(partial, bert.config)


def test_device_encoder_matches_jax_and_the_torch_contract(bert, tok):
    """encode_batch (buckets, mean pool under the mask, L2) equals the JAX
    twin's and the HF rung's host recipe, from an HF model and from its
    state dict with a config mapping."""
    got = DeviceBertEncoder(bert, tok, dim=64, max_length=32, device="cpu").encode_batch(TEXTS)
    assert got.shape == (len(TEXTS), 64)
    jax_got = JaxDeviceBert(bert, tok, dim=64, max_length=32).encode_batch(TEXTS)
    batch = tok(TEXTS, return_tensors="pt", padding=True, truncation=True, max_length=32)
    with torch.inference_mode():
        hidden = bert(input_ids=batch["input_ids"],
                      attention_mask=batch["attention_mask"]).last_hidden_state
    m = batch["attention_mask"].unsqueeze(-1).float()
    ref = ((hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)).numpy()
    ref = ref / (np.linalg.norm(ref, axis=-1, keepdims=True) + 1e-9)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jax_got, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-4)
    from_sd = DeviceBertEncoder(bert.state_dict(), tok, dim=64, max_length=32, device="cpu",
                                config=bert.config.to_dict())
    np.testing.assert_array_equal(from_sd.encode_batch(TEXTS), got)


def test_encode_ids_chunks_as_encode_batch_does(bert, tok):
    enc = DeviceBertEncoder(bert, tok, dim=64, max_length=32, batch_size=2, device="cpu")
    batch = tok(TEXTS, return_tensors="np", padding=True, truncation=True, max_length=32)
    got = enc.encode_ids(batch["input_ids"], batch["attention_mask"].astype(np.float32))
    np.testing.assert_allclose(got, enc.encode_batch(TEXTS), atol=1e-6)
    with pytest.raises(ValueError, match="config"):
        DeviceBertEncoder(bert.state_dict(), tok, device="cpu")


@pytest.mark.parametrize("dim", [96, 32])
def test_dim_fit_pads_or_truncates_as_jax(bert, tok, dim):
    got = DeviceBertEncoder(bert, tok, dim=dim, max_length=32, device="cpu").encode_batch(TEXTS)
    ref = JaxDeviceBert(bert, tok, dim=dim, max_length=32).encode_batch(TEXTS)
    assert got.shape == (len(TEXTS), dim)
    np.testing.assert_allclose(got, ref, **TOL)
    if dim > 64:
        assert np.all(got[:, 64:] == 0.0)


# ---- the length-aware planner (plan_chunks) ----------------------------------

def _lengths(kind, rng):
    """A request's string lengths: the fields traffic's mix (titles, OCR,
    comments), all long OCR, one length, or more strings than a chunk holds."""
    if kind == "fields":
        return np.concatenate([rng.integers(8, 49, 12), rng.integers(32, 257, 10),
                               rng.integers(4, 65, 60)])
    if kind == "ocr":
        return rng.integers(192, 257, 64)
    if kind == "equal":
        return np.full(40, 77)
    if kind == "one":
        return np.array([1])
    return rng.integers(0, 257, 700)  # "many": over batch_size, empty strings too


def _one_bucket_slots(lengths, batch_size, max_length):
    seq = seq_bucket(max(int(lengths.max()), 1), max_length)
    return sum(seq_bucket(min(batch_size, len(lengths) - s), batch_size) * seq
               for s in range(0, len(lengths), batch_size))


@pytest.mark.parametrize("cost", [0.0, port_bert.CHUNK_LAYER_FLOPS, 1e13])
@pytest.mark.parametrize("batch_size", [256, 24])
@pytest.mark.parametrize("kind", ["fields", "ocr", "equal", "one", "many"])
def test_plan_sorts_stays_on_the_grid_and_never_pads_more(kind, batch_size, cost):
    """Every string in exactly one chunk, the chunks in a stable sort by
    length; at most batch_size rows; each padded shape on the grid and holding
    its strings; no more padded slots than one power-of-two bucket."""
    lengths = _lengths(kind, np.random.default_rng(len(kind) + batch_size))
    plan = plan_chunks(lengths, batch_size, 256, bert_layer_flops(768, 3072), cost)
    order = np.concatenate([rows_of for rows_of, _, _ in plan])
    np.testing.assert_array_equal(order, np.argsort(lengths, kind="stable"))
    for rows_of, rows, seq in plan:
        assert 1 <= len(rows_of) <= rows <= batch_size
        assert rows % port_bert.ROW_STEP == 0 or rows == batch_size
        assert seq % port_bert.SEQ_STEP == 0 and lengths[rows_of].max() <= seq <= 256
    assert (sum(rows * seq for _, rows, seq in plan)
            <= _one_bucket_slots(lengths, batch_size, 256))
    if kind in ("equal", "one") or (kind == "ocr" and cost >= 1e13):
        assert len(plan) == -(-len(lengths) // batch_size)


def _mixed(rng, n=26, width=48):
    """Titles (8-14 tokens), comments (3-12) and long OCR strings (20-48), as
    one request, padded to its longest."""
    lengths = np.concatenate([rng.integers(8, 15, 6), rng.integers(20, width + 1, 5),
                              rng.integers(3, 13, n - 11)])
    rng.shuffle(lengths)
    mask = (np.arange(lengths.max())[None] < lengths[:, None]).astype(np.float32)
    ids = rng.integers(4, VOCAB, mask.shape) * mask
    return ids.astype(np.int64), mask


@pytest.mark.parametrize("cost", [0.0, port_bert.CHUNK_LAYER_FLOPS])
@pytest.mark.parametrize("batch_size", [256, 8])
def test_planned_chunks_match_one_bucket_and_count(bert, monkeypatch, batch_size, cost):
    """encode_ids over a mixed-length request equals the plain BertEncoder
    over the whole request in one power-of-two bucket, mean-pooled and
    L2-normalised, in the input order; the counters add up."""
    monkeypatch.setattr(port_bert, "CHUNK_LAYER_FLOPS", cost)
    enc = DeviceBertEncoder(bert, None, dim=64, max_length=48, batch_size=batch_size,
                            device="cpu")
    ids, mask = _mixed(np.random.default_rng(batch_size))
    n, width = ids.shape
    before = (port_bert.encode_chunks, port_bert.encode_padded_slots,
              port_bert.encode_real_slots)
    got = enc.encode_ids(ids, mask)
    plan = plan_chunks(port_bert.string_lengths(mask), batch_size, 48,
                       bert_layer_flops(64, 128), cost)
    assert (port_bert.encode_chunks - before[0], port_bert.encode_padded_slots - before[1],
            port_bert.encode_real_slots - before[2]) == (
        len(plan), sum(rows * seq for _, rows, seq in plan), int(mask.sum()))
    if batch_size < n or cost == 0.0:
        assert len(plan) > 1
    rows, seq = seq_bucket(n, 256), seq_bucket(width, 48)
    ids_p = np.zeros((rows, seq), np.int64)
    mask_p = np.zeros((rows, seq), np.float32)
    ids_p[:n, :width], mask_p[:n, :width] = ids, mask
    with torch.inference_mode():
        m = torch.from_numpy(mask_p)[..., None]
        hidden = enc.module(torch.from_numpy(ids_p), torch.from_numpy(mask_p))
        ref = ((hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6))[:n].numpy()
    ref = ref / (np.linalg.norm(ref, axis=-1, keepdims=True) + 1e-9)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert enc.encode_ids(ids[:0], mask[:0]).shape == (0, 64)
