"""PyTorch port, int8 serving weights (`ops/quant.py`) against the JAX
package's `ops/quant.py` on the CPU.

The int8 values and scales equal `quantize_tree`'s exactly, transposed
(a Flax kernel is (in, out) and quantized per output column; the port's
Linear weight is (out, in), quantized per row), over every weight of the
exported tower checkpoint; the same matrices are quantized and the same
stay f32. The quantized port Predictor matches the JAX
`Predictor(quantize=True)` within 1e-4 on prob_fake and the forensic keys.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ultrafnd_git_tpu.ops.quant import QKEY, SKEY, _quantize_leaf, is_quantized_leaf
from ultrafnd_git_tpu_torch.ops import quant
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.serving import Predictor

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
KEYS = ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity")
# Flax module names that the port's modules name otherwise
RENAME = {"evidence_in": "evidence_proj.0", "evidence_out": "evidence_proj.2",
          "fuse0": "fuse_mlp.0", "fuse1": "fuse_mlp.3", "head": "classifier",
          "pre0": "pre.0", "pre1": "pre.3"}


def _port_name(path):
    return ".".join(f"blocks.{k[5:]}" if k.startswith("block") and k[5:].isdigit()
                    else RENAME.get(k, k) for k in path)


def _jax_quantized(tree, path=()):
    """{(part, port module name): (leaf key, q, scale)} of a quantize_tree output."""
    out = {}
    for key, node in tree.items():
        if is_quantized_leaf(node):
            out[(path[0], _port_name(path[1:]))] = (key, np.asarray(node[QKEY]),
                                                    np.asarray(node[SKEY]))
        elif isinstance(node, dict):
            out.update(_jax_quantized(node, path + (key,)))
    return out


def test_quantize_weight_equals_jax_leaf():
    """Ties round half to even in both, an all-zero row takes scale 1."""
    w = np.zeros((4, 8), np.float32)
    w[0] = [127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -127.0]  # scale 1: exact ties
    w[1] = np.random.default_rng(0).standard_normal(8)
    w[3] = [1e-30, 0, 0, 0, 0, 0, 0, 0]
    q, scale = quant.quantize_weight(torch.from_numpy(w))
    ref = _quantize_leaf(jnp.asarray(w.T), channel_axis=1)  # Flax layout (in, out)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref[QKEY]).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref[SKEY]).T)
    assert q[0].tolist() == [127, 2, 4, -2, 0, 0, 2, -127] and scale[2].item() == 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_layers_dequantize_before_use(dtype):
    torch.manual_seed(0)
    lin, emb = nn.Linear(96, 64), nn.Embedding(100, 48)
    root = nn.ModuleDict({"lin": lin, "emb": emb, "small": nn.Linear(8, 4)})
    stats = quant.quantize_modules(root, dtype, min_size=4096)
    assert stats["quantized"] == 2 and isinstance(root["small"], nn.Linear)
    assert isinstance(root["lin"], quant.QuantDense)
    q, s = root["lin"].weight_q, root["lin"].weight_scale
    x = torch.randn(5, 96)
    w = (q.to(dtype) * s.to(dtype)).to(torch.float32)  # dequantized in dtype, computed in f32
    torch.testing.assert_close(root["lin"](x), x @ w.T + lin.bias.detach(), rtol=0, atol=1e-5)
    ids = torch.tensor([[3, 99, 0], [3, 3, 7]])
    table = quant.dequantize(root["emb"].weight_q, root["emb"].weight_scale, dtype)
    got = root["emb"](ids)
    assert got.dtype == dtype and torch.equal(got, table[ids])
    # per-element error of the f32 dequantization is at most half a scale
    err = (quant.dequantize(q, s) - lin.weight.detach()).abs()
    assert bool((err <= s / 2 + 1e-7).all())


@pytest.fixture(scope="module")
def exported(tower_ckpt, tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("torch_model")
    mod.export(tower_ckpt["out"], str(out))
    return str(out)


@pytest.fixture(scope="module")
def jax_quantized(tower_ckpt):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    return JaxPredictor(tower_ckpt["out"], quantize=True)


def test_int8_weights_equal_quantize_tree(exported, jax_quantized):
    ref = _jax_quantized(jax_quantized._score_params)
    pred = Predictor(exported, device="cpu", quantize=True)
    try:
        ours = {(part, name): (m.weight_q, m.weight_scale)
                for part, mod in pred.score_modules.items() for name, m in mod.named_modules()
                if isinstance(m, (quant.QuantDense, quant.QuantEmbedding))}
        full = pred.modules
    finally:
        pred.close()
    assert set(ours) == set(ref)
    assert {part for part, _ in ours} == {"fusion", "clf", "gnn", "text_tower"}
    for key, (q, scale) in ours.items():
        leaf, rq, rs = ref[key]
        if leaf == "kernel":  # (in, out) per output column -> (out, in) per row
            rq, rs = rq.T, rs.T
        np.testing.assert_array_equal(q.numpy(), rq, err_msg=str(key))
        np.testing.assert_array_equal(scale.numpy(), rs, err_msg=str(key))
    # the full-precision modules (explain's) keep their f32 weights
    assert full["text_tower"].tok_embed.weight.dtype == torch.float32


def test_quantized_predictor_matches_jax(exported, jax_quantized):
    records = load_records(FIXTURE)
    ref = jax_quantized.predict(records)
    pred = Predictor(exported, device="cpu", quantize=True)
    try:
        rows = pred.predict(records)
    finally:
        pred.close()
    assert [r["id"] for r in rows] == [r["id"] for r in ref]
    for key in KEYS:
        np.testing.assert_allclose([r[key] for r in rows], [r[key] for r in ref], atol=1e-4,
                                   err_msg=key)
    for o, r in zip(rows, ref):
        if abs(r["prob_fake"] - 0.5) > 1e-4:
            assert o["label"] == r["label"]
