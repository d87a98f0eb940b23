"""PyTorch port, K3 + K4: the plain backward against the JAX Pallas backward.

The JAX gradient is `jax.grad` of `flash_attention(..., backend="interpret",
mm_dtype=float32, bwd="pallas")`, its kernels run in interpret mode as the
JAX suite runs them on the CPU. The port's side is `attention_bwd_reference`
(the formulas K3 and K4 compute) and its CPU `flash_attention` under torch
autograd. Tolerance atol = rtol = 5e-4, the JAX suite's own for gradients
(tests/test_flash_attention.py). The CUDA kernels themselves run only on a
GPU: tests/test_torch_gpu.py.

Fully masked rows: P = exp(s - lse) is 1 per key there, not 1/S (see
csrc/flash_attention_bwd.cu), so the port is held to the JAX backward on
every row and to autograd of a softmax only on rows with a valid key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention,
    padding_bias as jax_padding_bias,
)
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

TOL = dict(atol=5e-4, rtol=5e-4)
CASES = {
    # name: (B, H, S, D, per-batch valid lengths or None)
    "no_mask": (2, 2, 64, 64, None),
    "padding_mask": (2, 2, 64, 64, [40, 64]),
    "fully_masked_row": (2, 2, 64, 64, [0, 17]),
    "ragged_s": (2, 2, 100, 64, [100, 63]),
    "head_dim_192": (2, 2, 64, 192, [64, 5]),
}


def _inputs(case):
    b, h, s, d, lengths = CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    if lengths is None:
        mask = np.ones((b, s), np.float32)
    else:
        mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask):
    """dq, dk, dv, dbias of sum(flash_attention(q, k, v, bias) * do)."""
    bias = jax_padding_bias(jnp.asarray(mask))

    def f(q, k, v, bias):
        out = jax_flash_attention(q, k, v, bias=bias, backend="interpret",
                                  mm_dtype=jnp.float32, bwd="pallas")
        return jnp.sum(out * jnp.asarray(do))

    grads = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v)), bias)
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_backward(case):
    q, k, v, do, mask = _inputs(case)
    ref = _jax_grads(q, k, v, do, mask)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    bias = fa.padding_bias(torch.from_numpy(mask))
    before = fa.bwd_launches
    out, lse = fa.flash_attention_fwd(tq, tk, tv, bias)
    ours = fa.flash_attention_bwd(tq, tk, tv, bias, out, lse, tdo)
    assert fa.bwd_launches == before == 0  # the CPU path launches no kernel
    assert ours[3].shape == (q.shape[0], 1, 1, q.shape[2])
    for name, o, r in zip(("dq", "dk", "dv", "dbias"), ours, ref):
        np.testing.assert_allclose(o.numpy(), r, err_msg=name, **TOL)
    assert all(torch.isfinite(o).all() for o in ours)


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_path_matches_jax_and_softmax_autograd(case):
    """The port's differentiable CPU `flash_attention` against the JAX
    backward (every row) and against autograd of plain softmax attention
    (rows with at least one valid key)."""
    q, k, v, do, mask = _inputs(case)
    ref = _jax_grads(q, k, v, do, mask)
    bias = fa.padding_bias(torch.from_numpy(mask)).requires_grad_()
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*leaves, bias).backward(torch.from_numpy(do))
    ours = [t.grad.numpy() for t in (*leaves, bias)]
    for name, o, r in zip(("dq", "dk", "dv", "dbias"), ours, ref):
        np.testing.assert_allclose(o, r, err_msg=name, **TOL)

    plain = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fa.reference_attention(*plain, fa.padding_bias(torch.from_numpy(mask)))[0].backward(
        torch.from_numpy(do))
    valid = mask.sum(axis=1) > 0  # batches with at least one valid key
    for name, o, t in zip(("dq", "dk", "dv"), ours, plain):
        np.testing.assert_allclose(o[valid], t.grad.numpy()[valid], err_msg=name, **TOL)


def test_fully_masked_row_follows_the_tpu_kernel_not_softmax_autograd():
    """On a batch whose keys are all masked, P = exp(s - lse) rounds to 1
    per key, so dV there is S times autograd's (which spreads 1/S)."""
    q, k, v, do, mask = _inputs("fully_masked_row")
    s = q.shape[2]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    bias = fa.padding_bias(torch.from_numpy(mask))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, bias)
    dv = fa.flash_attention_bwd(tq, tk, tv, bias, out, lse, tdo)[2]
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fa.reference_attention(*leaves, bias)[0].backward(tdo)
    np.testing.assert_allclose(dv[0].numpy(), s * leaves[2].grad[0].numpy(), **TOL)
    np.testing.assert_allclose(dv[0].numpy(), _jax_grads(q, k, v, do, mask)[2][0], **TOL)


def test_padded_keys_get_no_key_gradients():
    q, k, v, do, mask = _inputs("padding_mask")
    dq, dk, dv, _ = _jax_grads(q, k, v, do, mask)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    bias = fa.padding_bias(torch.from_numpy(mask))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, bias)
    _, ok, ov, _ = fa.flash_attention_bwd(tq, tk, tv, bias, out, lse, tdo)
    pad = mask[0] == 0  # batch 0 has 40 valid keys of 64
    assert pad.sum() == 24
    for g in (ok.numpy(), ov.numpy(), dk, dv):
        assert np.abs(g[0][:, pad]).max() < 1e-6


def test_bias_gradient_only_when_asked():
    q, k, v, do, mask = _inputs("padding_mask")
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    bias = fa.padding_bias(torch.from_numpy(mask))  # a mask: no gradient
    fa.flash_attention(*leaves, bias).backward(torch.from_numpy(do))
    assert bias.grad is None and all(t.grad is not None for t in leaves)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, bias)
    assert fa.flash_attention_bwd(tq, tk, tv, bias, out, lse, tdo, with_dbias=False)[3] is None


def test_inference_mode_runs_only_the_forward():
    q, k, v, _, mask = _inputs("no_mask")
    with torch.inference_mode():
        out = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 fa.padding_bias(torch.from_numpy(mask)))
    assert not out.requires_grad
    np.testing.assert_allclose(
        out.numpy(),
        fa.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)))[0].numpy(),
        atol=2e-5,
    )
