"""PyTorch port, the BERT rung's 3xTF32 linears on the CPU: the wrapper's
plain version, the split of W, the packed encoder against the plain
`BertEncoder`, and the benchmark's reader of the kernel's launches. No
GPU, no jax (the card's side is in tests/test_torch_gpu.py; the kernel's
arithmetic and layouts in tests/test_torch_fwd_design.py)."""
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ultrafnd_git_tpu_torch.kernels import gemm_tf32x3 as gk
from ultrafnd_git_tpu_torch.models import bert

CFG = dict(vocab_size=120, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=64, type_vocab_size=2,
           layer_norm_eps=1e-12)


@pytest.fixture(scope="module")
def plain():
    return bert.draw_weights_(bert.BertEncoder.from_config(CFG), seed=5).eval()


@pytest.fixture(scope="module")
def packed(plain):
    return bert.DeviceBertEncoder(plain.state_dict(), None, dim=64, max_length=48,
                                  batch_size=8, device="cpu", config=CFG)


def _batch(seed=0, rows=6, seq=40):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, seq + 1, rows)
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.float32)
    ids = (rng.integers(3, CFG["vocab_size"], mask.shape) * mask).astype(np.int64)
    return torch.from_numpy(ids), torch.from_numpy(mask)


@pytest.mark.parametrize("scale", [1.0, 1e-30, 3e30])
def test_split_is_tf32_and_exact(scale):
    """hi has its low 13 bits clear and is w rounded to TF32 (half an ulp
    added); lo = w - hi is at most half a TF32 ulp of w; hi + lo == w bit for
    bit, at ordinary, small and huge magnitudes."""
    w = torch.randn(257, 96, generator=torch.Generator().manual_seed(1)) * scale
    hi, lo = gk.split_tf32(w)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + lo, w)
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 11)  # a TF32 ulp of w
    assert bool((lo.abs() <= ulp / 2).all())
    with pytest.raises(ValueError, match="float32"):
        gk.split_tf32(w.double())


@pytest.mark.parametrize("gelu", [False, True])
def test_cpu_path_is_the_f32_linear_bit_for_bit(gelu):
    """On a CPU tensor the wrapper is F.linear on W = hi + lo (W's own bits),
    then the exact-erf GELU: the same bits as the plain f32 linear; no launch
    is counted."""
    g = torch.Generator().manual_seed(2)
    x, w, b = torch.randn(3, 7, 96, generator=g), torch.randn(192, 96, generator=g), \
        torch.randn(192, generator=g)
    before = gk.launches
    y = gk.linear_tf32x3(x, *gk.split_tf32(w), b, gelu=gelu)
    want = F.linear(x, w, b)
    assert torch.equal(y, F.gelu(want) if gelu else want)
    assert y.shape == (3, 7, 192) and gk.launches == before


def test_packed_encoder_keeps_the_hf_keys_and_buffers_out_of_them(plain, packed):
    """DeviceBertEncoder's module has BertEncoder's state-dict keys, shapes
    and values; the packed products are non-persistent buffers: W_hi, W_lo
    (N, K) of the concatenated q/k/v (N = 3 W) and of each dense, with their
    biases, made from the loaded weights."""
    sd, own = plain.state_dict(), packed.module.state_dict()
    assert list(own) == list(sd)
    for key, value in sd.items():
        assert torch.equal(own[key], value), key
    layer = packed.module.encoder.layer[1]
    assert isinstance(layer, bert.PackedBertLayer)
    att = layer.attention.self
    w = torch.cat([att.query.weight, att.key.weight, att.value.weight])
    assert layer.qkv.w_hi.shape == (3 * CFG["hidden_size"], CFG["hidden_size"])
    assert torch.equal(layer.qkv.w_hi + layer.qkv.w_lo, w)
    assert torch.equal(layer.qkv.bias, torch.cat([att.query.bias, att.key.bias, att.value.bias]))
    assert layer.ffn_in.gelu and not (layer.qkv.gelu or layer.attn_out.gelu or layer.ffn_out.gelu)
    assert torch.equal(layer.ffn_out.w_hi + layer.ffn_out.w_lo, layer.output.dense.weight)
    assert not any("w_hi" in k or "qkv" in k for k in own)


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_encoder_matches_the_unpacked_one(plain, packed, seed):
    """q/k/v fused and the GELU after the intermediate's product: the packed
    module's hidden states within 1e-6 of the plain BertEncoder's largest
    value on the same weights, padded rows and keys included."""
    ids, mask = _batch(seed)
    with torch.inference_mode():
        got, want = packed.module(ids, mask), plain(ids, mask)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_packed_layers_only_in_the_device_rung(plain):
    """BertEncoder (and so RoBERTa, which reuses its layers) keeps plain
    BertLayers; only DeviceBertEncoder builds PackedBertLayers."""
    assert all(type(layer) is bert.BertLayer for layer in plain.encoder.layer)
    from ultrafnd_git_tpu_torch.models import roberta

    assert all(type(layer) is bert.BertLayer
               for layer in roberta.RobertaClassifier.from_config(
                   dict(CFG, type_vocab_size=1, pad_token_id=1, id2label={0: "a", 1: "b"})
               ).encoder.layer)


def test_linear_share_reader_counts_launches_over_the_chunks_products(monkeypatch):
    """encode.tf32x3_linear_share: the kernel's launches over 4 x layers x
    the rung's planned chunks, in %; None without the kernel's module (the
    parent of this change) or without a chunk."""
    from portbench import harness

    read = harness.metric_reader("encode.tf32x3_linear_share")
    rec = {"cfg": {"num_hidden_layers": 12}}
    monkeypatch.setattr(gk, "launches", 96)
    monkeypatch.setattr(bert, "encode_chunks", 2)
    assert read(rec) == pytest.approx(100.0)
    monkeypatch.setattr(gk, "launches", 48)
    assert read(rec) == pytest.approx(50.0)
    monkeypatch.setattr(bert, "encode_chunks", 0)
    assert read(rec) is None
    monkeypatch.setattr(bert, "encode_chunks", 2)
    monkeypatch.delitem(sys.modules, "ultrafnd_git_tpu_torch.kernels.gemm_tf32x3")
    assert read(rec) is None
