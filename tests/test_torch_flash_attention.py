"""PyTorch port, K2: plain attention against the JAX Pallas forward kernel.

The JAX kernel runs in interpret mode with f32 matmuls, as the JAX suite
runs it on the CPU; the port's CPU path is its plain version. Tolerance
atol = rtol = 2e-5, the JAX suite's own (tests/test_flash_attention.py).
The CUDA kernel itself runs only on a GPU: tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.kernels.flash_attention import (
    _pallas_forward,
    flash_attention as jax_flash_attention,
    padding_bias as jax_padding_bias,
)
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(b, h, s, d, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    mask = None
    if lengths is not None:
        mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return q, k, v, mask


CASES = {
    # name: (B, H, S, D, per-batch valid lengths or None)
    "no_mask": (2, 2, 64, 64, None),
    "padding_mask": (2, 2, 64, 64, [40, 64]),
    "fully_masked_row": (2, 2, 64, 64, [0, 17]),
    "ragged_s": (2, 2, 100, 64, [100, 63]),
    "head_dim_192": (2, 2, 64, 192, [64, 5]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_attention_matches_pallas_kernel(case):
    b, h, s, d, lengths = CASES[case]
    q, k, v, mask = _inputs(b, h, s, d, lengths, seed=len(case))
    if mask is None:
        jbias = jnp.zeros((b, 1, 1, s), jnp.float32)
        tbias = None
    else:
        jbias = jax_padding_bias(jnp.asarray(mask))
        tbias = fa.padding_bias(torch.from_numpy(mask))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_out = jax_flash_attention(
        jq, jk, jv, bias=jbias, backend="interpret", mm_dtype=jnp.float32
    )
    _, ref_lse = _pallas_forward(
        jq, jk, jv, jbias, block_q=128, interpret=True, mm_dtype=jnp.float32
    )
    before = fa.launches
    out, lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), tbias
    )
    assert fa.launches == before  # the CPU path launches no kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    assert np.isfinite(out.numpy()).all()


def test_fully_masked_row_is_uniform_over_keys():
    q, k, v, mask = _inputs(1, 2, 48, 64, [0], seed=3)
    out, _ = fa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        fa.padding_bias(torch.from_numpy(mask)),
    )
    expect = np.broadcast_to(v.mean(axis=2, keepdims=True), v.shape)
    np.testing.assert_allclose(out.numpy(), expect, **TOL)


def _good(b=2, h=2, s=16, d=64):
    x = torch.zeros((b, h, s, d))
    return x, x.clone(), x.clone(), torch.zeros((b, 1, 1, s))


@pytest.mark.parametrize(
    "bad, error",
    [
        (lambda q, k, v, bias: (q[..., :32].contiguous(), k[..., :32].contiguous(),
                                v[..., :32].contiguous(), bias), ValueError),
        (lambda q, k, v, bias: (q, k[:, :, :8].contiguous(), v, bias), ValueError),
        (lambda q, k, v, bias: (q, k, v, bias[:, :, :, :8]), ValueError),
        (lambda q, k, v, bias: (q.double(), k, v, bias), TypeError),
        (lambda q, k, v, bias: (q.transpose(2, 3).contiguous().transpose(2, 3),
                                k, v, bias), ValueError),
        # the backward's incoming gradient dO must have q's shape
        (lambda q, k, v, bias: (q, k, v, bias, q.clone(), q[:, :, :8].contiguous()),
         ValueError),
    ],
    ids=["head_dim", "kv_shape", "bias_shape", "dtype", "layout", "grad"],
)
def test_kernel_argument_checks_raise(bad, error):
    with pytest.raises(error):
        fa._check(*bad(*_good()))


def test_argument_checks_accept_kernel_shapes():
    for d in fa.HEAD_DIMS:
        fa._check(*_good(d=d))


def test_non_cuda_device_raises():
    q, k, v, bias = (t.to("meta") for t in _good())
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention_fwd(q, k, v, bias)
