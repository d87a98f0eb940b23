"""PyTorch port, K3/K4's bf16 mode against the JAX package on the CPU.

(a) The plain twin `attention_bwd_reference_bf16` (what the CUDA kernel
csrc/flash_attention_bwd_bf16.cu is held to on the card), reached through
`flash_attention_bwd_bf16` on CPU tensors, against `jax.vjp` of the JAX
`flash_attention(..., backend="interpret", mm_dtype=bfloat16)` on bf16
inputs, the Pallas bf16 forward and backward (K2, K3, K4) in interpret
mode: dq, dk, dv and dbias within 8e-3 of max|ref| (one bf16 ulp at the top
of the range: both sides round dS and P to bf16 before their products and
round each output once, but from an out and lse that the two forwards
round at other points), for a full, a padded and a fully masked batch.
(b) The CPU paths: on a fully masked row P = exp(s - lse) is 1 per key, as
in the TPU kernels, so dV there is S times autograd's value of a softmax;
padded keys get exactly zero dk and dv; the autograd Function's bf16
backward is the twin and counts no launch; under inference_mode only the
forward runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from ultrafnd_git_tpu.kernels.flash_attention import padding_bias as jax_padding_bias
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

REL = 8e-3


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as f32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _case(b, h, s, d, seed):
    """bf16-valued q, k, v, dO (B, H, S, D) and a (B, S) mask: batch 0 full,
    batch 1 padded, batch 2 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(rng.standard_normal((b, h, s, d))) for _ in range(4))
    lengths = np.array([s, s // 3 + 1, 0])[:b]
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
    return q, k, v, do, mask


def _port_bwd(q, k, v, do, mask, with_dbias=True):
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    bias = fa.padding_bias(torch.from_numpy(mask), torch.bfloat16)
    out, lse = fa.flash_attention_fwd_bf16(tq, tk, tv, bias)
    return fa.flash_attention_bwd_bf16(tq, tk, tv, bias, out, lse, tdo, with_dbias=with_dbias)


@pytest.mark.parametrize("s", [64, 100, 512])
@pytest.mark.parametrize("d", [64, 128, 192])
def test_bf16_bwd_twin_matches_pallas_bf16_mode(d, s):
    q, k, v, do, mask = _case(3, 2, s, d, seed=d * 1000 + s)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jbias = jax_padding_bias(jnp.asarray(mask), jnp.bfloat16)
    _, vjp = jax.vjp(
        lambda q_, k_, v_, b_: jax_flash_attention(q_, k_, v_, b_, backend="interpret",
                                                   mm_dtype=jnp.bfloat16),
        jq, jk, jv, jbias)
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    before = (fa.bwd_launches, fa.bwd_bf16_launches)
    got = _port_bwd(q, k, v, do, mask)
    assert (fa.bwd_launches, fa.bwd_bf16_launches) == before  # the CPU path launches nothing
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape, name
        a = a.float().numpy()
        assert np.isfinite(a).all(), name
        err, top = np.abs(a - r).max(), np.abs(r).max()
        assert err <= REL * top, (name, err, top)


def test_bf16_bwd_fully_masked_and_padded_rows():
    """A fully masked batch: P = 1 per key, so dV is S x autograd's (whose
    softmax gives 1/S); a padded batch: keys past its length get exactly
    zero dk and dv, and its valid keys agree with autograd of a softmax."""
    b, h, s, d = 3, 2, 64, 64
    q, k, v, do, mask = _case(b, h, s, d, seed=5)
    dq, dk, dv, dbias = (x.float() for x in _port_bwd(q, k, v, do, mask))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, _ = fa.reference_attention(tq, tk, tv, fa.padding_bias(torch.from_numpy(mask)))
    out.backward(torch.from_numpy(do))
    auto_dv, auto_dk = tv.grad, tk.grad
    top = auto_dv.abs().max().item()
    # the fully masked batch 2
    assert (dv[2] - s * auto_dv[2]).abs().max().item() <= REL * s * auto_dv[2].abs().max().item()
    # the padded batch 1: keys past its length
    n = s // 3 + 1
    assert torch.count_nonzero(dk[1, :, n:]) == 0 and torch.count_nonzero(dv[1, :, n:]) == 0
    for a, r in ((dv[:2], auto_dv[:2]), (dk[:2], auto_dk[:2])):
        assert (a - r).abs().max().item() <= REL * max(top, r.abs().max().item())
    assert torch.isfinite(dq).all() and torch.isfinite(dbias).all()


def test_bf16_bwd_without_dbias_returns_none():
    q, k, v, do, mask = _case(2, 2, 64, 128, seed=6)
    with_db = _port_bwd(q, k, v, do, mask)
    without = _port_bwd(q, k, v, do, mask, with_dbias=False)
    assert without[3] is None and with_db[3].shape == (2, 1, 1, 64)
    for a, b in zip(with_db[:3], without[:3]):
        assert torch.equal(a, b)


def test_bf16_autograd_backward_is_the_twin_and_launches_nothing():
    """The autograd Function's bf16 backward on CPU tensors runs the twin
    (no mask gradient, as the trainer calls it) and counts no launch."""
    q, k, v, do, mask = _case(2, 2, 64, 64, seed=7)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    bias = fa.padding_bias(torch.from_numpy(mask), torch.bfloat16)
    before = (fa.launches, fa.bf16_launches, fa.bwd_launches, fa.bwd_bf16_launches)
    out = fa.flash_attention(tq, tk, tv, bias)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    assert (fa.launches, fa.bf16_launches, fa.bwd_launches, fa.bwd_bf16_launches) == before
    want = _port_bwd(q, k, v, do, mask, with_dbias=False)
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        assert t.grad.dtype == torch.bfloat16 and torch.equal(t.grad, w), name


def test_bf16_inference_mode_runs_only_the_forward():
    q, k, v, _, mask = _case(2, 2, 64, 64, seed=8)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    bias = fa.padding_bias(torch.from_numpy(mask), torch.bfloat16)
    with torch.inference_mode():
        out = fa.flash_attention(tq, tk, tv, bias)
    assert out.dtype == torch.bfloat16 and not out.requires_grad and out.grad_fn is None
    torch.testing.assert_close(out, fa.reference_attention_bf16(tq, tk, tv, bias)[0],
                               atol=0, rtol=0)
