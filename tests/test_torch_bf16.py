"""PyTorch port, the bf16 lever against the JAX package on the CPU.

(a) K2's bf16 mode: the port's plain twin `reference_attention_bf16` (what
the CUDA kernel is held to on the card) against the JAX Pallas forward in
interpret mode with bf16 inputs and `mm_dtype=bfloat16`, its default:
out within 8e-3 of max|ref| (one bf16 ulp at the top of the range) and
lse within 1e-4 (relative to |lse| where |lse| > 1: a fully masked row's
lse is -1e9 + log S).
(b) The modules' casts mirror Flax's `dtype=bfloat16` (Dense, LayerNorm,
the padding bias), and a fully masked record stays finite.
(c) The whole Predictor: `Predictor(bf16=True)` against the JAX
`Predictor(bf16=True)` on the shared tower checkpoint. Off the TPU the JAX
tower runs XLA attention with its softmax in bf16 (`flash_attention.py:
529-533`) where the port runs K2's bf16 mode, so this holds the envelope:
prob_fake within 2e-2 of JAX bf16 and within 5e-2 of the port's f32
Predictor (the JAX suite's own envelope, tests/test_serving.py:133), and
the labels agree.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from ultrafnd_git_tpu.kernels.flash_attention import _pallas_forward
from ultrafnd_git_tpu.kernels.flash_attention import padding_bias as jax_padding_bias
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
from ultrafnd_git_tpu_torch.models.layers import Dense, LayerNorm
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.serving import Predictor

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
OUT_REL = 8e-3
LSE_TOL = 1e-4


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("s", [64, 100, 512])
@pytest.mark.parametrize("d", [64, 128, 192])
def test_bf16_twin_matches_pallas_bf16_mode(d, s):
    b, h = 3, 2
    rng = np.random.default_rng(d * 1000 + s)
    q, k, v = (_bf16(rng.standard_normal((b, h, s, d)).astype(np.float32)) for _ in range(3))
    lengths = np.array([s, s // 3 + 1, 0])  # full, padded, fully masked
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
    jout, jlse = _pallas_forward(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jax_padding_bias(jnp.asarray(mask), jnp.bfloat16),
        block_q=128, interpret=True, mm_dtype=jnp.bfloat16)
    jout = np.asarray(jout.astype(jnp.float32))
    jlse = np.asarray(jlse).reshape(b, h, s)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    bias = fa.padding_bias(torch.from_numpy(mask), torch.bfloat16)
    out, lse = fa.flash_attention_fwd_bf16(tq, tk, tv, bias)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    out, lse = out.float().numpy(), lse.numpy()
    assert np.isfinite(out).all() and np.isfinite(lse).all()
    assert np.abs(out - jout).max() <= OUT_REL * np.abs(jout).max()
    np.testing.assert_allclose(lse, jlse, rtol=LSE_TOL, atol=LSE_TOL)
    # the fully masked batch: the uniform softmax, never NaN
    np.testing.assert_allclose(out[2], np.broadcast_to(v[2].mean(1, keepdims=True), v[2].shape),
                               atol=OUT_REL * np.abs(v[2]).max())


def test_bf16_padding_bias_equals_jax():
    mask = np.array([[1, 1, 0, 1], [0, 0, 0, 0]], np.float32)
    ours = fa.padding_bias(torch.from_numpy(mask), torch.bfloat16)
    ref = jax_padding_bias(jnp.asarray(mask), jnp.bfloat16)
    assert ours.dtype == torch.bfloat16 and ours.shape == (2, 1, 1, 4)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_bf16_attention_counts_no_launch_on_cpu_and_has_no_backward():
    """(The name predates K3/K4's bf16 mode.) On the CPU the bf16 attention
    and its backward run the plain twins and count no launch of any mode;
    the gradient is the twin's (`attention_bwd_reference_bf16`)."""
    q = torch.randn(2, 2, 16, 64).to(torch.bfloat16).requires_grad_(True)
    bias = fa.padding_bias(torch.ones(2, 16), torch.bfloat16)
    before = (fa.launches, fa.bf16_launches, fa.bwd_launches, fa.bwd_bf16_launches)
    out = fa.flash_attention(q, q, q, bias)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert (fa.launches, fa.bf16_launches, fa.bwd_launches, fa.bwd_bf16_launches) == before
    x = q.detach()
    o, lse = fa.reference_attention_bf16(x, x, x, bias)
    dq, dk, dv, _ = fa.attention_bwd_reference_bf16(x, x, x, bias, o, lse, torch.ones_like(o))
    # q is q, k and v at once: its gradient is the sum of the three
    assert q.grad.dtype == torch.bfloat16
    torch.testing.assert_close(q.grad.float(), (dq + dk + dv).float(), atol=1e-2, rtol=1e-2)


def test_dense_and_layer_norm_cast_like_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 48)).astype(np.float32)
    dense = Dense(48, 32, torch.bfloat16)
    flax_dense = nn.Dense(32, dtype=jnp.bfloat16)
    params = {"kernel": dense.weight.detach().numpy().T, "bias": dense.bias.detach().numpy()}
    ref = flax_dense.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = dense(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # a bf16 GEMM rounds once where XLA rounds the product and then the bias add
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)

    ln = LayerNorm(48, 1e-6, torch.bfloat16)
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5)
        ln.bias.uniform_(-0.5, 0.5)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = ln(xb)
        got_f32 = LayerNorm(48, 1e-6)(xb)  # dtype None: f32 out, as Flax
    flax_ln = nn.LayerNorm(dtype=jnp.bfloat16)
    lp = {"scale": ln.weight.detach().numpy(), "bias": ln.bias.detach().numpy()}
    ref = flax_ln.apply({"params": lp}, jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and got_f32.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_bf16_tower_keeps_a_fully_masked_record_finite():
    from ultrafnd_git_tpu_torch.models.initializers import seeded_init_
    from ultrafnd_git_tpu_torch.models.transformer import TextTransformer

    tower = TextTransformer(width=128, depth=2, heads=2, vocab_size=64, max_len=16,
                            dtype=torch.bfloat16)
    seeded_init_(tower, torch.Generator().manual_seed(0)).eval()
    ids = torch.randint(1, 64, (3, 16), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, 16)
    mask[1, 5:] = 0
    mask[2] = 0  # an empty record
    with torch.inference_mode():
        pooled = tower(ids, mask)
    assert pooled.dtype == torch.float32 and torch.isfinite(pooled).all()


@pytest.fixture(scope="module")
def exported(tower_ckpt, tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("torch_model")
    mod.export(tower_ckpt["out"], str(out))
    return str(out)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "bf16_quantize"])
def test_bf16_predictor_within_the_jax_envelope(tower_ckpt, exported, quantize):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    records = load_records(FIXTURE)
    ref = JaxPredictor(tower_ckpt["out"], bf16=True, quantize=quantize).predict(records)
    preds = {}
    for bf16 in (True, False):
        pred = Predictor(exported, device="cpu", bf16=bf16, quantize=quantize)
        try:
            preds[bf16] = pred.predict(records)
        finally:
            pred.close()
    ours, f32 = preds[True], preds[False]
    assert [r["id"] for r in ours] == [r["id"] for r in ref]
    p = np.array([r["prob_fake"] for r in ours])
    assert np.isfinite(p).all()
    assert np.abs(p - [r["prob_fake"] for r in ref]).max() <= 2e-2
    assert np.abs(p - [r["prob_fake"] for r in f32]).max() <= 5e-2
    assert [r["label"] for r in ours] == [r["label"] for r in ref]
    assert list(ours[0]) == list(ref[0])
