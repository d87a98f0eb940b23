"""PyTorch port, K2 and its bf16 mode as `torch.library` custom ops.

`ufnd::flash_attention_fwd` and `ufnd::flash_attention_fwd_bf16` are what
the text tower calls and what a program frozen by `torch.export` holds.
On the CPU their implementation is the plain version; `torch.library.opcheck`
checks each op's schema, its fake implementation against the real one,
its registered gradient (the fused backward's plain version) and its
trace under AOT dispatch with dynamic shapes. The CUDA implementations
(the kernels) are exercised in tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

OPS = {torch.float32: fa.fwd_op, torch.bfloat16: fa.fwd_bf16_op}


def _inputs(dtype, b=2, h=2, s=16, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
               .to(dtype).requires_grad_() for _ in range(3))
    mask = torch.ones(b, s)
    mask[1, 11:] = 0
    return q, k, v, fa.padding_bias(mask, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_opcheck(dtype):
    result = torch.library.opcheck(OPS[dtype], _inputs(dtype))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_implementation_gives_the_real_shapes(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    q, k, v, bias = (t.detach() for t in _inputs(dtype, s=24, d=128))
    real_out, real_lse = OPS[dtype](q, k, v, bias)
    with FakeTensorMode() as mode:
        out, lse = OPS[dtype](*(mode.from_tensor(t) for t in (q, k, v, bias)))
    assert (out.shape, out.dtype) == (real_out.shape, dtype) == (q.shape, dtype)
    assert (lse.shape, lse.dtype) == (real_lse.shape, torch.float32) == ((2, 2, 24),
                                                                         torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_op_is_the_forward_on_every_path(dtype):
    """flash_attention() returns the op's out, and its gradient is the fused
    backward's plain version on the same saved tensors."""
    q, k, v, bias = _inputs(dtype)
    out = fa.flash_attention(q, k, v, bias)
    ref, lse = (fa.reference_attention_bf16 if dtype == torch.bfloat16
                else fa.reference_attention)(q.detach(), k.detach(), v.detach(), bias)
    assert torch.equal(out.detach(), ref)
    do = torch.ones_like(out)
    out.backward(do)
    bwd = fa.flash_attention_bwd_bf16 if dtype == torch.bfloat16 else fa.flash_attention_bwd
    dq, dk, dv, _ = bwd(q.detach(), k.detach(), v.detach(), bias, ref, lse, do,
                        with_dbias=False)
    for got, want in ((q.grad, dq), (k.grad, dk), (v.grad, dv)):
        assert torch.equal(got, want)


def test_export_traces_the_op_by_name():
    class Attn(torch.nn.Module):
        def forward(self, q, k, v, bias):
            return fa.flash_attention(q, k, v, bias)

    q, k, v, bias = (t.detach() for t in _inputs(torch.float32))
    b = torch.export.Dim("b", min=1)
    ep = torch.export.export(Attn(), (q, k, v, bias),
                             dynamic_shapes=({0: b}, {0: b}, {0: b}, {0: b}), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert "ufnd.flash_attention_fwd.default" in targets
    q3, k3, v3, bias3 = (t[:1] for t in (q, k, v, bias))
    assert torch.equal(ep.module()(q3, k3, v3, bias3), fa.flash_attention(q3, k3, v3, bias3))
