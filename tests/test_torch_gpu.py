"""PyTorch port on a CUDA GPU: each kernel against its plain version, and
the serving and training paths on the GPU against the same model on the CPU.

Every test here carries the `gpu` marker and skips with a reason where
torch.cuda is unavailable. The file imports no jax, so it also runs on a
GPU machine without it:
    python -m pytest --noconftest -o addopts="" tests/test_torch_gpu.py -q
Tolerances: K2's bf16 mode (and its causal mode) out within 8e-3 of its
plain twin's largest value and lse 1e-4; K3/K4's bf16 mode dq, dk, dv and dbias within 8e-3 of
the twin's largest value (one bf16 ulp at the top of the range); the
bf16_compute step's gradient, GPU against CPU, within 5e-2 in relative L2
and 1e-1 of each leaf's largest (the CPU test's bounds against JAX); forward kernel atol = rtol = 2e-5 (both sides full-f32
matmuls, TF32 off) and out within 1e-5 of the plain version's largest
value (3xTF32 on the tensor cores); the fused backward atol = rtol = 5e-4 (the JAX suite's
gradient tolerance) and dq, dk, dv within 1e-5 of the plain version's
largest value (3xTF32 on the tensor cores keeps about f32 accuracy);
AdamW kernel bit-identical (torch.equal); tower atol
1e-5, its gradients rtol 1e-4 of each leaf's largest value; served values
atol 1e-4.
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch.kernels import adamw as aw
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    from ultrafnd_git_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize(
    "shape", [(256, 6, 64, 128), (8, 4, 64, 192), (2, 2, 100, 64),
              (2, 2, 512, 64), (2, 2, 77, 256)]
)
def test_flash_kernel_matches_plain_version(cuda, shape):
    b, h, s, d = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               for _ in range(3))
    lengths = rng.integers(0, s + 1, size=b)
    lengths[0] = 0  # a fully masked row
    mask = torch.from_numpy((np.arange(s)[None] < lengths[:, None]).astype(np.float32))
    bias = fa.padding_bias(mask.to(cuda))
    with torch.inference_mode():
        before = fa.launches
        out, lse = fa.flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        ref_out, ref_lse = fa.reference_attention(q, k, v, bias)
    torch.testing.assert_close(out, ref_out, **TOL)
    torch.testing.assert_close(lse, ref_lse, **TOL)


@pytest.mark.parametrize("s", [1, 64, 100, 2048])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_flash_fwd_every_width(cuda, d, s):
    """The tensor-core forward at every head width, S from 1 to 2048 (one
    or many key tiles, ragged tiles), a fully masked row: within 2e-5 of
    the plain version and out within 1e-5 of its largest value (3xTF32
    keeps about f32 accuracy), two calls bit for bit."""
    b, h = (2, 2) if s > 100 else (3, 4)
    rng = np.random.default_rng(d + s)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).to(cuda)
               for _ in range(3))
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = 0  # a fully masked row
    mask = torch.from_numpy((np.arange(s)[None] < lengths[:, None]).astype(np.float32))
    bias = fa.padding_bias(mask.to(cuda))
    with torch.no_grad():
        before = fa.launches
        out, lse = fa.flash_attention_fwd(q, k, v, bias)
        out2, lse2 = fa.flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        assert fa.launches == before + 2
        ref_out, ref_lse = fa.reference_attention(q, k, v, bias)
    torch.testing.assert_close(out, ref_out, **TOL)
    torch.testing.assert_close(lse, ref_lse, **TOL)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    err, top = (out - ref_out).abs().max().item(), ref_out.abs().max().item()
    assert err <= 1e-5 * top, (err, top)
    # the fully masked batch: uniform softmax over the keys, lse = -1e9 + log S
    torch.testing.assert_close(out[0], v[0].mean(dim=1, keepdim=True).expand_as(v[0]), **TOL)


def test_tower_on_gpu_matches_cpu_and_launches_per_layer(cuda):
    from ultrafnd_git_tpu_torch.models.initializers import seeded_init_
    from ultrafnd_git_tpu_torch.models.transformer import TextTransformer

    tower = TextTransformer(width=768, depth=2, heads=6, vocab_size=1024, max_len=64)
    seeded_init_(tower, torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(1, 1024, size=(16, 64)))
    lengths = rng.integers(0, 65, size=16)
    lengths[0] = 0
    mask = torch.from_numpy((np.arange(64)[None] < lengths[:, None]).astype(np.float32))
    with torch.inference_mode():
        cpu_out = tower(ids, mask)
        before = fa.launches
        gpu_out = tower.to(cuda)(ids.to(cuda), mask.to(cuda))
        assert fa.launches == before + 2  # one launch per encoder block
    torch.testing.assert_close(gpu_out.cpu(), cpu_out, atol=1e-5, rtol=0)


def _seeded_model_dir(root, tokens=False):
    """A small seeded tower model (width 768, one block of 6 heads of 128)
    over a 50-record corpus (with tower token ids when `tokens`), and 20
    records to score against it."""
    from ultrafnd_git_tpu_torch.serving import write_seeded_model_dir

    meta = {
        "cfg": {"train_text_tower": True},
        "fusion": {"hidden": 64, "use_gnn": True, "gnn_dim": 16, "text_dim": 768,
                   "audio_dim": 128, "visual_dim": 512, "temporal_dim": 32},
        "classifier": {"hidden": 32, "num_classes": 2, "use_aux": True, "aux_dim": 2,
                       "node_trees": 2, "node_depth": 3, "node_tau": 10.0,
                       "temperature_init": 1.0},
        "gnn": {"in_dim": 416 - 64 + 32, "hid": 32, "out_dim": 16},
        "align": {"in_dim": 768, "out_dim": 32},
        "text_tower": {"width": 768, "depth": 1, "heads": 6, "vocab_size": 32768,
                       "max_len": 64, "gelu": "tanh"},
    }
    rng = np.random.default_rng(2)
    n = 50
    words = [f"w{i}" for i in range(40)]
    corpus = {
        "ids": np.array([f"c{i}" for i in range(n)], dtype=object),
        "labels": np.zeros(n, np.int64),
        **{key: rng.standard_normal((n, w)).astype(np.float32) for key, w in
           (("text", 768), ("audio", 128), ("visual", 512), ("temporal", 32),
            ("aux", 2), ("evidence", 3))},
        "text_ids": np.zeros((n, 64), np.int32),
        "text_mask": np.zeros((n, 64), np.float32),
        "ocr_sets": [set(rng.choice(words, size=5, replace=False)) for _ in range(n)],
        "split": (np.arange(n), np.arange(0), np.arange(0)),
    }
    if tokens:
        lengths = rng.integers(1, 65, size=n)
        corpus["text_mask"] = (np.arange(64)[None] < lengths[:, None]).astype(np.float32)
        corpus["text_ids"] = (rng.integers(1, 32768, size=(n, 64)) * corpus["text_mask"]).astype(np.int32)
    write_seeded_model_dir(str(root), meta, corpus)
    records = [{"video_id": f"r{i}", "title": f"标题 {i} 外星人 警告",
                "ocr": " ".join(sorted(corpus["ocr_sets"][i])) if i % 3 else "",
                "comments": ["这是真的吗"] * (i % 2)} for i in range(20)]
    return records


def test_predictor_on_gpu_matches_cpu(cuda, tmp_path):
    from ultrafnd_git_tpu_torch.serving import Predictor

    records = _seeded_model_dir(tmp_path)
    gpu = Predictor(str(tmp_path), batch_size=8, device="cuda")
    cpu = Predictor(str(tmp_path), batch_size=8, device="cpu")
    try:
        before = fa.launches
        g_rows = gpu.predict(records)
        assert fa.launches == before + 1  # 20 rows: one GPU chunk, depth 1
        c_rows = cpu.predict(records)
    finally:
        gpu.close()
        cpu.close()
    assert [r["id"] for r in g_rows] == [r["id"] for r in c_rows]
    for key in ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity"):
        np.testing.assert_allclose([r[key] for r in g_rows], [r[key] for r in c_rows],
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize(
    "shape", [(512, 6, 64, 128), (8, 4, 64, 192), (2, 2, 100, 64), (2, 2, 512, 64),
              (2, 2, 77, 256)]
)
def test_flash_bwd_kernels_match_plain_version(cuda, shape):
    b, h, s, d = shape
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
                   for _ in range(4))
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = 0  # a fully masked row
    mask = torch.from_numpy((np.arange(s)[None] < lengths[:, None]).astype(np.float32))
    bias = fa.padding_bias(mask.to(cuda))
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, bias)
        before = fa.bwd_launches
        got = fa.flash_attention_bwd(q, k, v, bias, out, lse, do)
        torch.cuda.synchronize()
        assert fa.bwd_launches == before + 1
        ref = fa.attention_bwd_reference(q, k, v, bias, out, lse, do)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        torch.testing.assert_close(a, r, atol=5e-4, rtol=5e-4, msg=name)


def _bwd_case(cuda, shape, seed):
    """Seeded operands of one backward call; row 0 fully masked."""
    b, h, s, d = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
                   for _ in range(4))
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = 0
    mask = torch.from_numpy((np.arange(s)[None] < lengths[:, None]).astype(np.float32))
    bias = fa.padding_bias(mask.to(cuda))
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, bias)
    return q, k, v, bias, out, lse, do


@pytest.mark.parametrize("with_dbias", [True, False], ids=["dbias", "no_dbias"])
@pytest.mark.parametrize("s", [1, 64, 100, 512])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_fused_bwd_matches_plain_version(cuda, d, s, with_dbias):
    """The one-pass backward at every head width, S from 1 to 512 (one or
    several key blocks, ragged tiles), a fully masked row: dq, dk, dv within
    5e-4 of the plain version and within 1e-5 of its largest value; dbias
    within 1e-5 of its largest value (it sums S * H values of dS per key,
    and a fully masked row's are of order 1, so an elementwise bound does
    not scale with S). At S = 1, dS = P (dP - delta) is 0 up to rounding,
    so there every output is held to 5e-4 elementwise only."""
    args = _bwd_case(cuda, (2, 2, s, d), seed=d + s)
    with torch.no_grad():
        got = fa.flash_attention_bwd(*args, with_dbias=with_dbias)
        ref = fa.attention_bwd_reference(*args)
    torch.cuda.synchronize()
    assert (got[3] is None) == (not with_dbias)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if a is None:
            continue
        assert torch.isfinite(a).all(), name
        if name != "dbias" or s == 1:
            torch.testing.assert_close(a, r, atol=5e-4, rtol=5e-4, msg=name)
        if s > 1:
            err, top = (a - r).abs().max().item(), r.abs().max().item()
            assert err <= 1e-5 * top, (name, err, top)


@pytest.mark.parametrize("shape", [(512, 6, 64, 128), (2, 2, 512, 64), (2, 2, 100, 192)])
def test_fused_bwd_is_deterministic_and_one_launch(cuda, shape):
    """Two calls give the same bits (no float atomics; fixed-order sums of
    the dq and dbias partials), and each call is one launch."""
    args = _bwd_case(cuda, shape, seed=7)
    with torch.no_grad():
        before = fa.bwd_launches
        first = fa.flash_attention_bwd(*args)
        assert fa.bwd_launches == before + 1
        second = fa.flash_attention_bwd(*args)
        assert fa.bwd_launches == before + 2
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), first, second):
        assert torch.equal(a, b), name


def test_fused_adamw_kernel_is_bit_identical_to_plain(cuda):
    g = torch.Generator().manual_seed(0)
    shapes = [(32768, 768), (768,), (1, 64, 768), (3072, 768), (7,), (1,), (4097,)]
    params = {"a": torch.nn.ParameterDict(
        {f"p{i}": torch.nn.Parameter(torch.randn(sh, generator=g)) for i, sh in enumerate(shapes)}
    ).to(cuda)}
    plain_params = copy.deepcopy(params)
    schedule = lambda count: 2e-4 * 0.7 ** (count // 2)  # noqa: E731
    fused, plain = aw.FusedAdamW(schedule, 1e-4, 5.0), aw.AdamW(schedule, 1e-4, 5.0)
    sf, sp = fused.init(params), plain.init(plain_params)
    before = aw.launches
    for step in range(3):  # step 0 clips nothing, steps 1 and 2 clip
        grads = {"a": {n: (torch.randn(p.shape, generator=g) * (0.001 + step)).to(cuda)
                       for n, p in params["a"].named_parameters()}}
        fused.apply(params, sf, grads)
        plain.apply(plain_params, sp, grads)
    torch.cuda.synchronize()
    assert aw.launches == before + 3
    for (n, a), b in zip(params["a"].named_parameters(), plain_params["a"].parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(sf["mu"]["a"][n], sp["mu"]["a"][n]), n
        assert torch.equal(sf["nu"]["a"][n], sp["nu"]["a"][n]), n


def test_fused_adamw_odd_unaligned_and_fresh_leaves(cuda):
    """Leaves of 1, 3, 4 and 4097 elements (scalar tails), one whose p, m and
    v are offset views (not 16-byte aligned: the kernel's scalar path), and
    grads that are fresh tensors each step (the pointer table is built and
    sent again each step): bit-identical to the plain update."""
    g = torch.Generator().manual_seed(1)
    sizes = [1, 3, 4, 4097, 70001]
    whole = [torch.randn(70002, generator=g).to(cuda), torch.zeros(70002, device=cuda),
             (torch.rand(70002, generator=g) * 1e-4).to(cuda)]
    fused = [  # p, m, v; the last leaf's are offset views (data_ptr % 16 == 4)
        [torch.randn(n, generator=g).to(cuda) for n in sizes] + [whole[0][1:]],
        [torch.zeros(n, device=cuda) for n in sizes] + [whole[1][1:]],
        [(torch.rand(n, generator=g) * 1e-4).to(cuda) for n in sizes] + [whole[2][1:]],
    ]
    plain = [[t.clone() for t in col] for col in fused]
    opt = aw.AdamW(lambda count: 2e-4 * 0.5 ** count, 1e-4, 5.0)
    before, builds = aw.launches, aw.table_builds
    for step in range(3):
        grads = [torch.randn(p.shape, generator=g).to(cuda) * (1e-3 + step) for p in plain[0]]
        scal = opt.scalars({"a": dict(enumerate(grads))}, step)
        aw.fused_adamw_(list(zip(*fused, grads)), scal)
        for p, m, v, gr in zip(*plain, grads):
            aw.adamw_reference_(p, m, v, gr, scal)
    torch.cuda.synchronize()
    assert aw.launches == before + 3
    assert aw.table_builds == builds + 3  # each step's grads are new tensors
    for col_f, col_p in zip(fused, plain):
        for i, (a, b) in enumerate(zip(col_f, col_p)):
            assert torch.equal(a, b), i
    assert torch.equal(whole[0][1:], plain[0][-1])  # updated in place through the view


def test_fused_adamw_builds_its_table_only_when_a_pointer_moves(cuda):
    """Two K1 updates of the same leaves build and send the pointer table
    once; new gradient tensors build it once more (leaf sizes no other
    test uses, so the first call cannot find its table already built)."""
    g = torch.Generator().manual_seed(2)
    sizes = [12345, 777]
    p, m, v = ([torch.randn(n, generator=g).to(cuda) for n in sizes],
               [torch.zeros(n, device=cuda) for n in sizes],
               [torch.zeros(n, device=cuda) for n in sizes])
    grads = [torch.randn(n, generator=g).to(cuda) for n in sizes]
    opt = aw.AdamW(lambda count: 1e-3, 1e-4, 1.0)
    scal = opt.scalars({"a": dict(enumerate(grads))}, 0)
    builds, before = aw.table_builds, aw.launches
    aw.fused_adamw_(list(zip(p, m, v, grads)), scal)
    aw.fused_adamw_(list(zip(p, m, v, grads)), scal)
    assert aw.table_builds == builds + 1
    fresh = [t.clone() for t in grads]  # new tensors while the old are alive
    aw.fused_adamw_(list(zip(p, m, v, fresh)), scal)
    torch.cuda.synchronize()
    assert aw.table_builds == builds + 2 and aw.launches == before + 3


def test_tower_backward_on_gpu_matches_cpu(cuda):
    from ultrafnd_git_tpu_torch.models.initializers import seeded_init_
    from ultrafnd_git_tpu_torch.models.transformer import TextTransformer

    tower = TextTransformer(width=768, depth=2, heads=6, vocab_size=1024, max_len=64)
    seeded_init_(tower, torch.Generator().manual_seed(0))
    gpu_tower = copy.deepcopy(tower).to(cuda)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(1, 1024, size=(16, 64)))
    lengths = rng.integers(1, 65, size=16)
    mask = torch.from_numpy((np.arange(64)[None] < lengths[:, None]).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 768)).astype(np.float32))
    (tower(ids, mask) * w).sum().backward()
    f0, b0 = fa.launches, fa.bwd_launches
    (gpu_tower(ids.to(cuda), mask.to(cuda)) * w.to(cuda)).sum().backward()
    assert (fa.launches - f0, fa.bwd_launches - b0) == (2, 2)  # one of each per block
    for (n, a), b in zip(gpu_tower.named_parameters(), tower.parameters()):
        err = (a.grad.cpu() - b.grad).abs().max() / b.grad.abs().max().clamp_min(1e-30)
        assert err <= 1e-4, (n, float(err))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_moe_tower_on_gpu_matches_cpu_and_routes_alike(cuda, remat):
    """The switch-MoE tower (8 experts) forward and backward on the GPU
    against the CPU: every token routed to the same expert and slot, pooled
    output and aux within 1e-5, gradients within 1e-4 of each leaf's
    largest; K2 launches once a block, twice under remat (the recompute),
    K3/K4 once a block."""
    from ultrafnd_git_tpu_torch.models.initializers import seeded_init_
    from ultrafnd_git_tpu_torch.models.moe import MoEFFN
    from ultrafnd_git_tpu_torch.models.transformer import TextTransformer

    tower = TextTransformer(width=768, depth=2, heads=6, vocab_size=1024, max_len=64,
                            moe_experts=8, remat=remat)
    seeded_init_(tower, torch.Generator().manual_seed(0))
    gpu_tower = copy.deepcopy(tower).to(cuda)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(1, 1024, size=(16, 64)))
    lengths = rng.integers(1, 65, size=16)
    mask = torch.from_numpy((np.arange(64)[None] < lengths[:, None]).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 768)).astype(np.float32))
    routes = {"cpu": [], "gpu": []}
    for name, t in (("cpu", tower), ("gpu", gpu_tower)):
        for mod in t.modules():
            if isinstance(mod, MoEFFN):
                def hook(m, args, _name=name):
                    with torch.no_grad():
                        _, _, expert, _, slot = m.route(args[0])
                    routes[_name].append((expert.cpu(), slot.cpu()))
                mod.register_forward_pre_hook(hook)
    pooled, aux = tower(ids, mask, return_aux=True)
    ((pooled * w).sum() + aux).backward()
    f0, b0 = fa.launches, fa.bwd_launches
    g_pooled, g_aux = gpu_tower(ids.to(cuda), mask.to(cuda), return_aux=True)
    ((g_pooled * w.to(cuda)).sum() + g_aux).backward()
    assert (fa.launches - f0, fa.bwd_launches - b0) == ((4 if remat else 2), 2)
    for (ec, sc), (eg, sg) in zip(routes["cpu"], routes["gpu"][:2]):
        assert torch.equal(ec, eg) and torch.equal(sc, sg)
    torch.testing.assert_close(g_pooled.detach().cpu(), pooled.detach(), atol=1e-5, rtol=0)
    assert abs(float(g_aux) - float(aux)) <= 1e-5 * abs(float(aux))
    for (n, a), b in zip(gpu_tower.named_parameters(), tower.parameters()):
        err = (a.grad.cpu() - b.grad).abs().max() / b.grad.abs().max().clamp_min(1e-30)
        assert err <= 1e-4, (n, float(err))


@pytest.mark.parametrize("s", [1, 64, 100, 2048])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_flash_fwd_bf16_every_width(cuda, d, s):
    """K2's bf16 mode at every head width, S from 1 to 2048, a fully masked
    row: out within 8e-3 of the plain twin's largest value (one bf16 ulp at
    the top of the range; the kernel rounds P against a running max), lse
    within 1e-4, two calls bit for bit, one launch each."""
    b, h = (2, 2) if s > 100 else (3, 4)
    rng = np.random.default_rng(d + s)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
               .to(cuda, torch.bfloat16) for _ in range(3))
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = 0  # a fully masked row
    mask = torch.from_numpy((np.arange(s)[None] < lengths[:, None]).astype(np.float32))
    bias = fa.padding_bias(mask.to(cuda), torch.bfloat16)
    with torch.inference_mode():
        before = fa.bf16_launches, fa.launches
        out, lse = fa.flash_attention_fwd_bf16(q, k, v, bias)
        out2, lse2 = fa.flash_attention_fwd_bf16(q, k, v, bias)
        torch.cuda.synchronize()
        assert (fa.bf16_launches, fa.launches) == (before[0] + 2, before[1])
        ref_out, ref_lse = fa.reference_attention_bf16(q, k, v, bias)
    assert out.dtype == torch.bfloat16 and torch.equal(out, out2) and torch.equal(lse, lse2)
    err = (out.float() - ref_out.float()).abs().max().item()
    assert err <= 8e-3 * ref_out.float().abs().max().item(), err
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    uniform = v[0].float().mean(dim=1, keepdim=True).expand_as(v[0])
    assert (out[0].float() - uniform).abs().max().item() <= 8e-3 * v[0].float().abs().max().item()


def _bf16_inputs(shape, seed, cuda):
    b, h, s, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(cuda, torch.bfloat16) for _ in range(3))
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = 0  # a fully masked row
    mask = torch.from_numpy((np.arange(s)[None] < lengths[:, None]).astype(np.float32))
    return q, k, v, fa.padding_bias(mask.to(cuda), torch.bfloat16)


@pytest.mark.parametrize("shape", [(512, 6, 64, 128), (2, 2, 2048, 256)],
                         ids=["training_shape", "s2048_d256"])
def test_flash_fwd_bf16_many_items_and_fewest_stages(cuda, shape):
    """The training shape (many work items for each persistent CTA) and S =
    2048 at D = 256 (32 key tiles through a ring of two stages): out within
    8e-3 of the twin's largest value, lse within 1e-4, two calls bit for bit."""
    q, k, v, bias = _bf16_inputs(shape, shape[2] + shape[3], cuda)
    with torch.inference_mode():
        out, lse = fa.flash_attention_fwd_bf16(q, k, v, bias)
        out2, lse2 = fa.flash_attention_fwd_bf16(q, k, v, bias)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.reference_attention_bf16(q, k, v, bias)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    err = (out.float() - ref_out.float()).abs().max().item()
    assert err <= 8e-3 * ref_out.float().abs().max().item(), err
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [1, 100, 300])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_fwd_bf16_causal_every_width(cuda, d, s):
    """K2-bf16's causal mode at every head width, S not a multiple of the
    64-key tile (one, two and five tiles), right-padded rows and a fully
    masked one: out within 8e-3 of the causal twin's largest value, lse
    within 1e-4, two calls bit for bit, one causal launch each and no
    launch of the plain mode."""
    q, k, v, bias = _bf16_inputs((3, 4, s, d), 7 * d + s, cuda)
    with torch.inference_mode():
        before = fa.bf16_causal_launches, fa.bf16_launches
        out, lse = fa.flash_attention_fwd_bf16_causal(q, k, v, bias)
        out2, lse2 = fa.flash_attention_fwd_bf16_causal(q, k, v, bias)
        torch.cuda.synchronize()
        assert (fa.bf16_causal_launches, fa.bf16_launches) == (before[0] + 2, before[1])
        ref_out, ref_lse = fa.reference_attention_bf16(q, k, v, bias, causal=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    err = (out.float() - ref_out.float()).abs().max().item()
    assert err <= 8e-3 * ref_out.float().abs().max().item(), err
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(64, 32, 256, 64), (2, 2, 2048, 256)],
                         ids=["lm_chunk", "s2048_d256"])
def test_flash_fwd_bf16_causal_beside_the_plain_mode(cuda, shape):
    """The language model's attention shape (rows of 32 heads at S = 256)
    and 32 key tiles through a ring of two stages: the causal mode against
    its twin, and the plain mode's output the same bits before and after
    the causal instantiation ran, and still its own twin's."""
    q, k, v, bias = _bf16_inputs(shape, shape[2], cuda)
    with torch.inference_mode():
        plain_before = fa.flash_attention_fwd_bf16(q, k, v, bias)
        out, lse = fa.flash_attention_fwd_bf16_causal(q, k, v, bias)
        plain_after = fa.flash_attention_fwd_bf16(q, k, v, bias)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.reference_attention_bf16(q, k, v, bias, causal=True)
        plain_ref = fa.reference_attention_bf16(q, k, v, bias)[0]
    assert all(torch.equal(a, b) for a, b in zip(plain_before, plain_after))
    err = (out.float() - ref_out.float()).abs().max().item()
    assert err <= 8e-3 * ref_out.float().abs().max().item(), err
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    err = (plain_after[0].float() - plain_ref.float()).abs().max().item()
    assert err <= 8e-3 * plain_ref.float().abs().max().item(), err


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_fwd_bf16_smem_fits_the_sm(cuda, d):
    """Each width's rings, staging tiles and barriers, as the kernel sizes
    them, fit in the shared memory a block of this card may opt in to."""
    props = torch.cuda.get_device_properties(cuda)
    assert fa._bf16_smem(d) <= props.shared_memory_per_block_optin


def test_flash_fwd_bf16_raises_on_a_misaligned_view(cuda):
    """TMA needs 16-byte-aligned tensors: a contiguous view that starts one
    element into its storage raises before any launch."""
    shape = (2, 2, 64, 64)
    q, k, v, bias = _bf16_inputs(shape, 0, cuda)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(shape)
    shifted.copy_(q)
    before = fa.bf16_launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_fwd_bf16(shifted, k, v, bias)
    assert fa.bf16_launches == before


@pytest.mark.parametrize("levers", [{"bf16": True}, {"quantize": True},
                                    {"bf16": True, "quantize": True}],
                         ids=["bf16", "quantize", "bf16_quantize"])
def test_predictor_levers_on_gpu_match_cpu(cuda, tmp_path, levers):
    """bf16 serving runs K2's bf16 mode (and no f32 K2), quantize alone the f32
    K2; each GPU Predictor within 2e-2 of the same levers on the CPU (1e-4
    for quantize alone, whose arithmetic is f32)."""
    from ultrafnd_git_tpu_torch.serving import Predictor

    records = _seeded_model_dir(tmp_path)
    gpu = Predictor(str(tmp_path), batch_size=8, device="cuda", **levers)
    cpu = Predictor(str(tmp_path), batch_size=8, device="cpu", **levers)
    try:
        before = fa.launches, fa.bf16_launches
        g_rows = gpu.predict(records)
        launched = fa.launches - before[0], fa.bf16_launches - before[1]
        c_rows = cpu.predict(records)
    finally:
        gpu.close()
        cpu.close()
    assert launched == ((0, 1) if levers.get("bf16") else (1, 0))
    tol = 2e-2 if levers.get("bf16") else 1e-4
    for key in ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity"):
        np.testing.assert_allclose([r[key] for r in g_rows], [r[key] for r in c_rows],
                                   atol=tol, err_msg=key)


@pytest.mark.parametrize("with_dbias", [True, False], ids=["dbias", "no_dbias"])
@pytest.mark.parametrize("s", [64, 100, 512])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_flash_bwd_bf16_matches_twin(cuda, d, s, with_dbias):
    """K3/K4's bf16 mode at every head width, one or several key blocks,
    ragged tiles, a fully masked row: within 8e-3 of the twin's largest
    value, one launch a call, no f32 backward launch."""
    args = [t.to(torch.bfloat16) for t in _bwd_case(cuda, (2, 3, s, d), seed=d + s)]
    args[4], args[5] = fa.flash_attention_fwd_bf16(*args[:4])  # bf16 out, f32 lse
    with torch.no_grad():
        before = fa.bwd_bf16_launches, fa.bwd_launches
        got = fa.flash_attention_bwd_bf16(*args, with_dbias=with_dbias)
        torch.cuda.synchronize()
        assert (fa.bwd_bf16_launches, fa.bwd_launches) == (before[0] + 1, before[1])
        ref = fa.attention_bwd_reference_bf16(*args)
    assert (got[3] is None) == (not with_dbias)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if a is None:
            continue
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all(), name
        err = (a.float() - r.float()).abs().max().item()
        assert err <= 8e-3 * r.float().abs().max().item(), (name, err)


@pytest.mark.parametrize("shape", [(512, 6, 64, 128), (2, 2, 512, 64), (2, 2, 100, 192)])
def test_flash_bwd_bf16_is_deterministic(cuda, shape):
    """Two calls give the same bits (fixed-order sums of the dq slabs and
    the dbias partials, no float atomics)."""
    args = [t.to(torch.bfloat16) for t in _bwd_case(cuda, shape, seed=9)]
    args[4], args[5] = fa.flash_attention_fwd_bf16(*args[:4])
    with torch.no_grad():
        first = fa.flash_attention_bwd_bf16(*args)
        second = fa.flash_attention_bwd_bf16(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), first, second):
        assert torch.equal(a, b), name


def test_bf16_compute_train_step_on_gpu(cuda, tmp_path):
    """One bf16_compute step on the card runs K2-bf16 and K3/K4-bf16 once a
    block and K1 once, no f32 attention kernel; its gradient against the
    same trainer on the CPU."""
    from ultrafnd_git_tpu_torch.kernels import adamw as aw
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

    _seeded_model_dir(tmp_path / "model", tokens=True)

    def trainer(device, out):
        cfg = TrainConfig(out_dir=str(tmp_path / out), model_dir=str(tmp_path / "model"),
                          batch_size=16, epochs=1, seed=0, train_text_tower=True,
                          text_tower_depth=1, text_tower_heads=6, bf16_compute=True)
        return ForensicTrainer(cfg, device=device)

    gpu, cpu = trainer("cuda", "gpu"), trainer("cpu", "cpu")
    for part, mod in cpu.state.params.items():
        mod.load_state_dict({k: v.cpu() for k, v in gpu.state.params[part].state_dict().items()})
    idx, mask = torch.arange(50), torch.ones(50)  # every row: bf16 noise averages over rows
    _, g_gpu, _ = gpu.grads_of(idx.to(cuda), mask.to(cuda))
    _, g_cpu, _ = cpu.grads_of(idx, mask)
    for part, leaves in g_cpu.items():
        for name, c in leaves.items():
            d = g_gpu[part][name].float().cpu() - c
            assert d.norm().item() <= 5e-2 * c.norm().item() + 1e-30, (part, name)
            assert d.abs().max().item() <= 1e-1 * c.abs().max().item() + 1e-30, (part, name)
    counts = lambda: (fa.launches, fa.bf16_launches, fa.bwd_launches,  # noqa: E731
                      fa.bwd_bf16_launches, aw.launches)
    before = counts()
    gpu.train_step(np.arange(16), np.ones(16, np.float32))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 1, 0, 1, 1)


FIXTURES = Path(__file__).resolve().parents[1] / "tests" / "fixtures"


def test_cache_built_on_gpu_matches_cpu_build(cuda):
    """The align pass on the card against the same seeded build on the CPU:
    host keys equal, align-derived keys within 1e-5 of their largest."""
    from ultrafnd_git_tpu_torch.data import cache as cache_mod
    from ultrafnd_git_tpu_torch.data.dataset import FakeSVRawDataset

    raw = FakeSVRawDataset(str(FIXTURES / "fakesv_hard"))
    gpu, cpu = (cache_mod.build_feature_cache(
        raw, seed=4, encoders=cache_mod.make_encoders(seed=4, device=dev))
        for dev in ("cuda", "cpu"))
    assert list(gpu["ids"]) == list(cpu["ids"]) and gpu["ocr_sets"] == cpu["ocr_sets"]
    for key in ("labels", "text", "audio", "visual", "text_ids", "text_mask"):
        np.testing.assert_array_equal(gpu[key], cpu[key], err_msg=key)
    np.testing.assert_array_equal(gpu["evidence"][:, :2], cpu["evidence"][:, :2])
    np.testing.assert_array_equal(gpu["aux"][:, 1], cpu["aux"][:, 1])
    for key in ("temporal", "aux", "evidence"):
        assert np.abs(gpu[key] - cpu[key]).max() <= 1e-5 * np.abs(cpu[key]).max(), key


def test_evidence_model_trained_on_gpu_serves_as_on_cpu(cuda, tmp_path):
    """Train from the raw fixture root with use_evidence on the card, export,
    and serve the export on the card and on the CPU (atol 1e-4)."""
    from ultrafnd_git_tpu_torch.predict import load_records
    from ultrafnd_git_tpu_torch.serving import Predictor
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig
    from ultrafnd_git_tpu_torch.utils.transfer import export_trained

    root = FIXTURES / "fakesv_tiny"
    cfg = TrainConfig(data_root=str(root), out_dir=str(tmp_path / "run"), batch_size=16,
                      epochs=1, seed=0, use_evidence=True, train_text_tower=True,
                      text_tower_depth=1, text_tower_heads=4)
    before = fa.launches, fa.bwd_launches, aw.launches
    trainer = ForensicTrainer(cfg, device="cuda")
    assert trainer.cache_source == "data_root" and "evidence" in trainer.corpus
    trainer.fit()
    assert fa.launches > before[0] and fa.bwd_launches > before[1] and aw.launches > before[2]
    served = export_trained(str(tmp_path / "run"), "best", str(tmp_path / "served"))
    records = load_records(root / "data_complete.json")
    gpu = Predictor(str(served), device="cuda")
    cpu = Predictor(str(served), device="cpu")
    try:
        g_rows, c_rows = gpu.predict(records), cpu.predict(records)
    finally:
        gpu.close()
        cpu.close()
    assert [r["id"] for r in g_rows] == [r["id"] for r in c_rows]
    for key in ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity"):
        np.testing.assert_allclose([r[key] for r in g_rows], [r[key] for r in c_rows],
                                   atol=1e-4, err_msg=key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_op_launches_its_kernel_eager_and_exported(cuda, dtype):
    """`ufnd::flash_attention_fwd[_bf16]` launches its kernel once per call,
    called eagerly and from a program frozen by torch.export, with the same
    bits both ways."""
    counter = "bf16_launches" if dtype == torch.bfloat16 else "launches"

    class Attn(torch.nn.Module):
        def forward(self, q, k, v, bias):
            return fa.flash_attention(q, k, v, bias)

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 6, 64, 128)).astype(np.float32))
               .to(cuda, dtype) for _ in range(3))
    mask = torch.ones(4, 64, device=cuda)
    mask[1, 40:] = 0
    bias = fa.padding_bias(mask, dtype)
    b = torch.export.Dim("b", min=1)
    with torch.no_grad():
        ep = torch.export.export(Attn(), (q, k, v, bias),
                                 dynamic_shapes=({0: b}, {0: b}, {0: b}, {0: b}), strict=False)
    with torch.inference_mode():
        before = getattr(fa, counter)
        eager = fa.flash_attention(q, k, v, bias)
        torch.cuda.synchronize()
        assert getattr(fa, counter) == before + 1
        frozen = ep.module()(q[:3], k[:3], v[:3], bias[:3])
        torch.cuda.synchronize()
        assert getattr(fa, counter) == before + 2
    assert torch.equal(frozen, eager[:3])


def test_artifact_and_legacy_path_on_gpu_match(cuda, tmp_path):
    """An artifact exported on the card serves the live GPU rows within
    1e-6; one exported on the CPU serves on the card within 1e-4 of the CPU
    Predictor; the legacy path on the card within 1e-5 of the fused rows.
    The artifact launches K2 once per chunk (depth 1; 20 records in chunks
    of batch_size 8)."""
    from ultrafnd_git_tpu_torch.export_serving import ExportedPredictor, export_artifact
    from ultrafnd_git_tpu_torch.serving import Predictor

    records = _seeded_model_dir(tmp_path / "m", tokens=True)
    gpu = Predictor(str(tmp_path / "m"), batch_size=8, device="cuda")
    cpu = Predictor(str(tmp_path / "m"), batch_size=8, device="cpu")
    legacy = Predictor(str(tmp_path / "m"), batch_size=8, device="cuda", fused_align=False)
    try:
        live, c_rows, l_rows = gpu.predict(records), cpu.predict(records), legacy.predict(records)
        export_artifact(gpu, str(tmp_path / "a_gpu"), platforms=("cuda",))
        export_artifact(cpu, str(tmp_path / "a_cpu"))
    finally:
        for p in (gpu, cpu, legacy):
            p.close()
    keys = ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity")
    for path, ref, tol in (("a_gpu", live, 1e-6), ("a_cpu", c_rows, 1e-4)):
        art = ExportedPredictor(str(tmp_path / path), device="cuda")
        try:
            before = fa.launches
            rows = art.predict(records)
            assert fa.launches == before + 3
        finally:
            art.close()
        for key in keys:
            np.testing.assert_allclose([r[key] for r in rows], [r[key] for r in ref],
                                       atol=tol, err_msg=f"{path} {key}")
    for key in keys:
        np.testing.assert_allclose([r[key] for r in l_rows], [r[key] for r in live],
                                   atol=1e-5, err_msg=key)


def test_seeded_text_rung_on_gpu_launches_k2_and_matches_cpu(cuda):
    """The seeded tower at full width (768, 12 heads of 64, S = 256, depth 4)
    on the card: K2 once per block and chunk (600 strings in chunks of 256:
    3 chunks), rows within 1e-5 of the same draw on the CPU."""
    from ultrafnd_git_tpu_torch.models.transformer import DeviceTextEncoder

    words = ("外星人", "入侵", "警告", "辟谣", "证据", "科学", "视频", "专家")
    rng = np.random.default_rng(0)
    texts = [" ".join(rng.choice(words, size=int(rng.integers(1, 9)))) for _ in range(600)]
    kw = dict(dim=768, depth=4, heads=12, max_len=256, seed=0)
    gpu, cpu = DeviceTextEncoder(**kw, device="cuda"), DeviceTextEncoder(**kw, device="cpu")
    before = fa.launches
    out = gpu.encode_batch(texts, batch_size=256)
    assert fa.launches - before == 4 * 3
    np.testing.assert_allclose(out, cpu.encode_batch(texts, batch_size=256), atol=1e-5)


def test_trained_text_rung_serves_an_out_dir_on_gpu_as_on_cpu(cuda, tmp_path, monkeypatch):
    """ULTRAFND_TEXT_DEVICE_CKPT at a run trained on the card: the Predictor
    of its latest slot featurizes through the trained tower (K2 in the
    featurize thread and in the scoring program: 2 launches a chunk at
    depth 1) and scores as the CPU Predictor of the slot (atol 1e-4)."""
    from ultrafnd_git_tpu_torch.predict import load_records
    from ultrafnd_git_tpu_torch.serving import Predictor
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

    root = FIXTURES / "fakesv_tiny"
    out = tmp_path / "run"
    cfg = TrainConfig(data_root=str(root), out_dir=str(out), batch_size=16, epochs=1, seed=0,
                      train_text_tower=True, text_tower_depth=1, text_tower_heads=4)
    ForensicTrainer(cfg, device="cuda").fit()
    monkeypatch.setenv("ULTRAFND_TEXT_DEVICE", "1")
    monkeypatch.setenv("ULTRAFND_TEXT_DEVICE_CKPT", str(out))
    records = load_records(root / "data_complete.json")
    gpu = Predictor(out_dir=str(out), checkpoint_name="latest", device="cuda")
    cpu = Predictor(out_dir=str(out), checkpoint_name="latest", device="cpu")
    try:
        before = fa.launches
        g_rows = gpu.predict(records)
        assert fa.launches - before == 2  # 64 records: one chunk
        c_rows = cpu.predict(records)
    finally:
        gpu.close()
        cpu.close()
    for key in ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity"):
        np.testing.assert_allclose([r[key] for r in g_rows], [r[key] for r in c_rows],
                                   atol=1e-4, err_msg=key)


def test_device_cv_stage_on_gpu_matches_cpu(cuda):
    """The v1 device CV stage on the card against the same torch code on the
    CPU: (2, 6, 256, 256) gray clips of 8-px blocks moving (-4, +2) px a
    frame; integer block displacements equal, flow_feat 1e-5, cuts 1e-6,
    flow_mags 1e-5 of their largest; two calls on the card bit-identical."""
    from ultrafnd_git_tpu_torch.kernels import preprocess as pre

    rng = np.random.default_rng(0)
    base = np.kron(rng.integers(0, 256, (48, 48)), np.ones((8, 8))).astype(np.uint8)
    # frame t shows base[4t :, 64 - 2t :]: the content moves up 4 px, right 2
    clips = np.stack([np.stack([base[4 * t : 256 + 4 * t, 64 - 2 * t : 320 - 2 * t]
                                for t in range(6)])] * 2)
    gpu, cpu = pre.DeviceCVStage(device="cuda"), pre.DeviceCVStage(device="cpu")
    g, g2, c = gpu(clips), gpu(clips), cpu(clips)
    for k in g:
        assert np.array_equal(g[k], g2[k]), k
    np.testing.assert_allclose(g["flow_feat"], c["flow_feat"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(g["cuts"], c["cuts"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(g["flow_mags"], c["flow_mags"],
                               atol=1e-5 * float(np.abs(c["flow_mags"]).max()), rtol=0)
    half = pre._pyr_down(pre.gray_resize(torch.from_numpy(clips).to(cuda)))
    u, v = pre.block_match_flow(half[:, :-1].reshape(-1, 128, 128),
                                half[:, 1:].reshape(-1, 128, 128))
    inner = (slice(None), slice(2, -2), slice(2, -2))
    assert abs(float(v[inner].median()) * 2 + 4.0) < 0.3  # full-raster px
    assert abs(float(u[inner].median()) * 2 - 2.0) < 0.3


def test_v1_ensemble_steps_through_k1_on_gpu(cuda):
    """The v1 ensemble (E = 2, batch 8): one K1 launch a step and nothing
    else launches it; one dropout-off gradient on the card against the CPU
    within 1e-4 of each leaf's largest value plus 1e-9."""
    from ultrafnd_git_tpu_torch.training import pipeline_v1 as v1

    cfg = v1.V1Config(batch_size=8, ensemble_size=2)
    gpu, cpu = v1.EnsembleTrainer(cfg, device="cuda"), v1.EnsembleTrainer(cfg, device="cpu")
    feats, labels = v1._dummy_feature_batches(8, 8, seed=0)[0]
    lam, perm = v1.mixup_arrays(np.random.default_rng(0), 8, 0.2)
    g_grads = gpu.grads_of(feats, labels, lam, perm)[1]
    c_grads = cpu.grads_of(feats, labels, lam, perm)[1]
    for gm, cm in zip(g_grads, c_grads):
        for part in gm:
            for name, g in gm[part].items():
                r = cm[part][name].numpy()
                gap = float(np.abs(g.cpu().numpy() - r).max())
                assert gap <= 1e-4 * float(np.abs(r).max()) + 1e-9, f"{part}.{name}"
    before = aw.launches
    rng = np.random.default_rng(1)
    losses = [gpu.train_batch(feats, labels, rng) for _ in range(3)]
    assert aw.launches - before == 3 == gpu.step_count
    assert np.isfinite(losses).all()
    assert gpu.predict_batch(feats).shape == (8, 2)


def test_v1_ensemble_k1_step_equals_plain_update_on_gpu(cuda):
    """Two steps of the v1 ensemble through K1 (its 2-member leaf table, no
    clip of its own, each member's grads scaled by its own clip, member 0's
    over it) against the same steps through the plain update on the card,
    from the same state: params, mu and nu bit for bit."""
    from ultrafnd_git_tpu_torch.training import pipeline_v1 as v1

    cfg = v1.V1Config(batch_size=8, ensemble_size=2)
    fused, plain = v1.EnsembleTrainer(cfg, device="cuda"), v1.EnsembleTrainer(cfg, device="cuda")
    plain.tx = aw.AdamW(fused.tx.schedule, fused.tx.weight_decay, fused.tx.grad_clip)
    feats, labels = v1._dummy_feature_batches(8, 8, seed=0)[0]
    lam, perm = v1.mixup_arrays(np.random.default_rng(0), 8, 0.2)
    before = aw.launches
    for step in range(2):
        grads = fused.grads_of(feats, labels, lam, perm)[1]
        grads[0] = {part: {n: g * 1e3 for n, g in d.items()} for part, d in grads[0].items()}
        fused.apply_grads(grads)
        plain.apply_grads(grads)
    torch.cuda.synchronize()
    assert aw.launches - before == 2
    for part, mod in fused.params.items():
        other = dict(plain.params[part].named_parameters())
        for n, p in mod.named_parameters():
            assert torch.equal(p, other[n]), f"{part}.{n}"
            for slot in ("mu", "nu"):
                assert torch.equal(fused.opt_state[slot][part][n],
                                   plain.opt_state[slot][part][n]), f"{slot} {part}.{n}"


MESH_STEPS = r"""
import json, sys
import torch
from ultrafnd_git_tpu_torch.kernels import adamw as aw
from ultrafnd_git_tpu_torch.parallel import collectives as coll
from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

model, out = sys.argv[1], sys.argv[2]


def trainer(name, device="cuda", **mesh):
    cfg = TrainConfig(out_dir=f"{out}/{name}", model_dir=model, batch_size=16, epochs=1,
                      seed=0, train_text_tower=True, text_tower_depth=1, text_tower_heads=6,
                      **mesh)
    return ForensicTrainer(cfg, device=device)


losses, trainers = {}, {}
# one after the other: each trainer seeds np.random's shuffle stream
for name, mesh in (("plain", {}), ("mesh", dict(dp=1, tp=1, shard_corpus=True, shard_graph=True))):
    trainers[name] = t = trainer(name, **mesh)
    before, calls = aw.launches, coll.calls
    losses[name] = [float(t.train_step(c, m)[0]) for c, m, _ in t.epoch_batches(t.tr_idx, True)[:2]]
    torch.cuda.synchronize()
    losses[name + "_k1"], losses[name + "_collectives"] = aw.launches - before, coll.calls - calls
plain, mesh = trainers["plain"], trainers["mesh"]
worst = 0.0
for part, mod in plain.state.params.items():
    theirs = mesh.state.params[part].state_dict()
    for key, p in mod.state_dict().items():
        gap = (theirs[key] - p).abs().max().item() / max(p.abs().max().item(), 1e-30)
        worst = max(worst, gap)
backend = mesh.mesh.backend
# then a CPU mesh (against the plain trainer on the CPU: the CPU draws
# other dropout masks) and a CUDA one again in this process: each starts
# the local group anew with its own backend
again = {}
for name, device, mesh_kw in (("cpu_plain", "cpu", {}),
                              ("cpu", "cuda", dict(dp=1, mesh_backend="cpu")),
                              ("again", "cuda", dict(dp=1))):
    t = trainer(name, device, **mesh_kw)
    c, m, _ = t.epoch_batches(t.tr_idx, True)[0]
    again[name] = [float(t.train_step(c, m)[0]), t.mesh and t.mesh.backend, str(t.device)]
print("RESULT " + json.dumps({**losses, "worst_rel": worst, "backend": backend,
                              "owned": sorted(mesh._owned), "again": again}))
torch.distributed.destroy_process_group()
"""


def test_world_one_nccl_mesh_steps_equal_the_plain_steps(cuda, tmp_path):
    """The mesh code path at world 1 over a real NCCL group (a one-rank local
    group; the corpus and graph rows through the owner-fills gather) takes
    the plain trainer's two dropout steps: losses and parameters within
    1e-6 relative, one K1 launch a step on each. A CPU mesh and then a
    CUDA mesh after it in the same process each start the local group
    anew with their own backend and take the same first step."""
    import json
    import os
    import subprocess
    import sys

    _seeded_model_dir(tmp_path / "model", tokens=True)
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", MESH_STEPS, str(tmp_path / "model"),
                           str(tmp_path / "runs")], cwd=repo, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=str(repo)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.split("RESULT ")[-1])
    assert res["backend"] == "nccl" and "a_norm" in res["owned"]
    np.testing.assert_allclose(res["mesh"], res["plain"], rtol=1e-6, atol=0)
    assert res["worst_rel"] <= 1e-6
    assert res["plain_k1"] == res["mesh_k1"] == 2
    assert res["plain_collectives"] == 0 < res["mesh_collectives"]
    cpu_loss, cpu_backend, cpu_device = res["again"]["cpu"]
    assert cpu_backend == "gloo" and cpu_device == "cpu"
    assert abs(cpu_loss - res["again"]["cpu_plain"][0]) <= 1e-6 * abs(cpu_loss)
    again_loss, again_backend, again_device = res["again"]["again"]
    assert again_backend == "nccl" and again_device == "cuda:0"
    assert abs(again_loss - res["mesh"][0]) <= 1e-6 * abs(res["mesh"][0])


SP_PP_STEPS = r"""
import json, sys
import torch
from ultrafnd_git_tpu_torch.kernels import adamw as aw
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
from ultrafnd_git_tpu_torch.parallel.mesh import maybe_initialize_distributed
from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

model, out, layout, device = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), sys.argv[4]
if not maybe_initialize_distributed(backend="gloo"):
    raise SystemExit("no coordinator")


def steps(name, **mesh):
    cfg = TrainConfig(out_dir=f"{out}/{name}", model_dir=model, batch_size=16, epochs=1,
                      seed=0, train_text_tower=True, text_tower_depth=2, text_tower_heads=6,
                      **mesh)
    t = ForensicTrainer(cfg, device=device)
    seen, apply = [], t.tx.apply

    def recording(trainable, opt_state, grads):  # each step's summed gradients
        seen.append({f"{p}.{k}": g.detach().double().cpu() for p, d in grads.items()
                     for k, g in d.items()})
        return apply(trainable, opt_state, grads)

    t.tx.apply = recording
    before = (fa.launches, fa.bwd_launches, aw.launches)
    losses = [float(t.train_step(c, m)[0]) for c, m, _ in t.epoch_batches(t.tr_idx, True)[:2]]
    if device == "cuda":
        torch.cuda.synchronize()
    counts = [a - b for a, b in zip((fa.launches, fa.bwd_launches, aw.launches), before)]
    params = {f"{p}.{k}": v.detach().double().cpu() for p, m in t.state.params.items()
              for k, v in m.state_dict().items()}
    return losses, counts, params, seen


losses, counts, params, grads = steps("mesh", **layout)
torch.distributed.barrier()
plain, plain_counts, plain_params, plain_grads = steps("plain")  # one rank, no mesh
rms = [{k: float(g.pow(2).mean().sqrt()) for k, g in step.items()} for step in plain_grads]
tree_rms = [(sum(float(g.pow(2).sum()) for g in step.values())
             / sum(g.numel() for g in step.values())) ** 0.5 for step in plain_grads]


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


err = sum(float((params[k] - v).pow(2).sum()) for k, v in plain_params.items())
leaves = {k: {"rel": rel(params[k], v), "value_rms": float(v.pow(2).mean().sqrt()),
              "grad_rms": [r[k] for r in rms],
              "grad_err_rms": [float((a[k] - b[k]).pow(2).mean().sqrt())
                               for a, b in zip(grads, plain_grads)]}
          for k, v in plain_params.items() if k in plain_grads[0]}
print("RESULT " + json.dumps({
    "losses": losses, "plain": plain, "counts": counts, "plain_counts": plain_counts,
    "tree_rel": (err / sum(float(v.pow(2).sum()) for v in plain_params.values())) ** 0.5,
    "tree_grad_rms": tree_rms, "leaves": leaves}))
torch.distributed.destroy_process_group()
"""
GRAD_TOL = 1e-5  # a leaf's summed gradient: its error's RMS over the larger of its and the tree's


@pytest.mark.parametrize("layout", [{"sp": 2}, {"pp": 2, "pp_microbatches": 4}],
                         ids=["sp2", "pp2_mb4"])
def test_two_gloo_ranks_train_sp_and_pp_as_one_card(cuda, tmp_path, layout):
    """Two ranks share the card over gloo (NCCL refuses two ranks on one
    GPU) at --sp 2 and at --pp 2 --pp_microbatches 4 (depth 2, full width):
    two dropout steps take the plain trainer's losses within 1e-6
    relative and its parameters as a whole tree within 1e-6 relative L2
    (chip_smoke.py's bounds). Each leaf's summed gradient of each step is
    held to the plain one's: the RMS of the difference within GRAD_TOL of
    the larger of the leaf's RMS and the whole tree's. A gradient summed
    twice over sp or pipe, or short of a rank's share, is off by half its
    RMS or more; a leaf whose reference gradient is rounding noise is held
    at the tree's scale (the forest's leaves at init, 1e-13 to 1e-8 of the
    tree's: Adam normalises them, so their values, under 1e-7, differ
    leaf by leaf in the noise's sign; an attention key bias, a cancelling
    sum). Under pp each rank launches K2 and K3/K4 for its block on each
    microbatch, under sp none (the ring is plain torch); K1 once a step on
    each."""
    import json
    import os
    import socket
    import subprocess
    import sys

    _seeded_model_dir(tmp_path / "model", tokens=True)
    repo = Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SP_PP_STEPS, str(tmp_path / "model"), str(tmp_path / "runs"),
         json.dumps(layout), "cuda"], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(repo), JAX_NUM_PROCESSES="2",
                 JAX_COORDINATOR_ADDRESS=f"localhost:{port}", JAX_PROCESS_ID=str(r)))
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    for o in outs:
        res = json.loads(o.split("RESULT ")[-1].splitlines()[0])
        gaps = {k: max(e / max(r, t) for e, r, t in
                       zip(v["grad_err_rms"], v["grad_rms"], res["tree_grad_rms"]))
                for k, v in res["leaves"].items()}
        print(json.dumps({"layout": layout, "tree_rel": res["tree_rel"],
                          "worst_grad_gap": sorted(gaps.items(), key=lambda kv: -kv[1])[:4],
                          "worst_param_rel": sorted(
                              ((k, v["rel"], v["value_rms"]) for k, v in res["leaves"].items()),
                              key=lambda kv: -kv[1])[:4]}))
        np.testing.assert_allclose(res["losses"], res["plain"], rtol=1e-6, atol=0)
        assert res["tree_rel"] <= 1e-6
        for key, gap in gaps.items():
            assert gap <= GRAD_TOL, (key, res["leaves"][key])
        fwd, bwd, k1 = res["counts"]
        assert k1 == 2 == res["plain_counts"][2]
        if "pp" in layout:  # one block a stage, run on each of its 4 microbatches
            assert fwd == bwd == 2 * layout["pp_microbatches"]
        else:
            assert fwd == bwd == 0


# ---- the HF twins (models/bert.py, roberta.py, w2v2.py, clip.py) ------------

HF_TWIN_REL = 1e-4  # a twin's pooled output, K2 against the plain attention on the card
TWIN_BERT = dict(model_type="bert", vocab_size=200, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=256, max_position_embeddings=300,
                 type_vocab_size=2, layer_norm_eps=1e-12)
TWIN_ROBERTA = dict(TWIN_BERT, model_type="roberta", type_vocab_size=1, pad_token_id=1,
                    layer_norm_eps=1e-5, id2label={0: "anger", 1: "fear", 2: "joy"})
# the BASE conv stack on 80,000 samples gives S = 249 frames (odd, ragged tiles)
TWIN_W2V2 = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=256, conv_dim=(32,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                 conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_bias=False, num_conv_pos_embeddings=128,
                 num_conv_pos_embedding_groups=16, layer_norm_eps=1e-5)


def _twin(kind, device):
    from ultrafnd_git_tpu_torch.models import bert, roberta, w2v2

    cls, cfg = {"bert": (bert.DeviceBertEncoder, TWIN_BERT),
                "roberta": (roberta.DeviceEmotionClassifier, TWIN_ROBERTA),
                "w2v2": (w2v2.DeviceW2V2Encoder, TWIN_W2V2)}[kind]
    module = {"bert": bert.BertEncoder, "roberta": roberta.RobertaClassifier,
              "w2v2": w2v2.Wav2Vec2Encoder}[kind].from_config(cfg)
    sd = bert.draw_weights_(module, seed=7).state_dict()
    if kind == "w2v2":
        return cls(sd, dim=64, device=device, config=cfg)
    return cls(sd, None, max_length=256, device=device, config=cfg)


def _twin_run(kind, twin):
    rng = np.random.default_rng(3)
    if kind == "w2v2":
        return twin.encode_batch(list(rng.standard_normal((3, 80000)).astype(np.float32)))
    ids = rng.integers(3, 200, (5, 256))
    lengths = np.array([256, 200, 77, 1, 130])
    mask = (np.arange(256)[None] < lengths[:, None]).astype(np.float32)
    ids[mask == 0] = 1 if kind == "roberta" else 0
    return (twin.predict_ids if kind == "roberta" else twin.encode_ids)(ids, mask)


@pytest.mark.parametrize("kind", ["bert", "roberta", "w2v2"])
def test_hf_twin_launches_k2_and_matches_plain_attention(cuda, kind):
    """Each K2 twin at D = 64 on the card: K2 once a layer a chunk (S = 256,
    and S = 249 for wav2vec2), its output within 1e-4 of the same module
    with the plain attention, and of its CPU run."""
    from ultrafnd_git_tpu_torch.models.bert import plain_attention, set_attention

    twin = _twin(kind, "cuda")
    before = fa.launches
    got = _twin_run(kind, twin)
    assert fa.launches - before == TWIN_BERT["num_hidden_layers"]
    set_attention(twin.module, plain_attention)
    plain = _twin_run(kind, twin)
    assert fa.launches - before == TWIN_BERT["num_hidden_layers"]
    cpu = _twin_run(kind, _twin(kind, "cpu"))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= HF_TWIN_REL * scale
    assert np.abs(got - cpu).max() <= HF_TWIN_REL * scale


def test_hf_twin_head_width_outside_the_kernel_raises(cuda):
    """D = 16 is not a width K2 was built for: the twin raises on the card
    (it does not take the plain path)."""
    twin_cfg = dict(TWIN_BERT, hidden_size=64, num_attention_heads=4)
    from ultrafnd_git_tpu_torch.models import bert

    sd = bert.draw_weights_(bert.BertEncoder.from_config(twin_cfg), seed=1).state_dict()
    twin = bert.DeviceBertEncoder(sd, None, dim=64, device="cuda", config=twin_cfg)
    with pytest.raises(ValueError, match="head dim 16"):
        twin.encode_ids(np.ones((2, 8), np.int64), np.ones((2, 8), np.float32))


def test_bert_twin_plans_chunks_on_the_card(cuda, monkeypatch):
    """A mixed-length request (titles, comments, long OCR strings) through
    the planner on the card: several chunks through K2, rows in the input
    order, within 1e-4 of the largest value of the whole request in one
    bucket on the plain attention on the same device."""
    from ultrafnd_git_tpu_torch.models import bert

    monkeypatch.setattr(bert, "CHUNK_LAYER_FLOPS", 0.0)  # split wherever padding drops
    twin = _twin("bert", "cuda")
    rng = np.random.default_rng(5)
    lengths = np.concatenate([rng.integers(8, 49, 12), rng.integers(32, 257, 10),
                              rng.integers(4, 65, 60)])
    rng.shuffle(lengths)
    mask = (np.arange(256)[None] < lengths[:, None]).astype(np.float32)
    ids = (rng.integers(3, 200, mask.shape) * mask).astype(np.int64)
    chunks, launches = bert.encode_chunks, fa.launches
    got = twin.encode_ids(ids, mask)
    chunks = bert.encode_chunks - chunks
    assert chunks > 1
    assert fa.launches - launches == chunks * TWIN_BERT["num_hidden_layers"]
    bert.set_attention(twin.module, bert.plain_attention)
    with torch.inference_mode():
        ids_p = torch.zeros((128, 256), dtype=torch.int64, device="cuda")
        mask_p = torch.zeros((128, 256), device="cuda")
        ids_p[:len(ids)], mask_p[:len(ids)] = torch.from_numpy(ids), torch.from_numpy(mask)
        m = mask_p[..., None]
        pooled = (twin.module(ids_p, mask_p) * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)
    want = bert.l2_rows(bert.fit_dim(pooled[:len(ids)].cpu().numpy(), twin.dim))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= HF_TWIN_REL * np.abs(want).max()


def test_clip_twin_on_gpu_matches_cpu(cuda):
    from ultrafnd_git_tpu_torch.models import bert, clip

    cfg = dict(vocab_size=300, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=256, max_position_embeddings=77, projection_dim=64,
               eos_token_id=2)
    sd = bert.draw_weights_(clip.ClipTextEncoder.from_config(cfg), seed=2).state_dict()
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 299, (4, 64))
    mask = np.ones((4, 64), np.float32)
    ids[:, 20], mask[:, 21:] = 299, 0.0  # legacy pooling: argmax(ids)
    got, cpu = (clip.DeviceClipTextEncoder(sd, None, device=d, config=cfg).encode_ids(ids, mask)
                for d in ("cuda", "cpu"))
    np.testing.assert_allclose(got, cpu, atol=1e-4)


def test_lm_rung_launches_causal_k2_and_matches_its_plain_path(cuda):
    """A mixed-length request through the LM rung at the CPU tests' small
    size (two query heads of 64 over one KV head, 8 experts top-2) on the
    card: K2-bf16's causal mode once an attention layer a chunk and no other
    attention kernel, the grouped expert products; each attention call
    within 8e-3 and each expert product within 1e-2 of its plain version's
    largest value on the same operands (bf16 both: the routing of one path
    is the other's); the rows unit vectors."""
    from _lfm2_reference import SMALL, draw
    from ultrafnd_git_tpu_torch.models import bert, lfm2

    enc = lfm2.DeviceLfm2Encoder(draw(SMALL, seed=3), None, SMALL, dim=96, max_length=64,
                                 batch_size=16, device=str(cuda))
    assert lfm2.grouped_products(torch.zeros(1, device=cuda, dtype=torch.bfloat16)) \
        is lfm2._grouped
    rng = np.random.default_rng(8)
    lengths = np.concatenate([rng.integers(8, 49, 12), rng.integers(4, 65, 20)])
    mask = (np.arange(64)[None] < lengths[:, None]).astype(np.float32)
    ids = (rng.integers(3, 300, mask.shape) * mask).astype(np.int64)
    chunks, before = bert.encode_chunks, (fa.bf16_causal_launches, fa.bf16_launches)
    enc.encode_ids(ids, mask)
    chunks = bert.encode_chunks - chunks
    assert chunks > 1
    assert (fa.bf16_causal_launches - before[0], fa.bf16_launches - before[1]) == (chunks, 0)
    gaps = lfm2.held_to_plain(enc.module)
    rows = enc.encode_ids(ids, mask)
    assert gaps["attention"] <= 8e-3 and gaps["experts"] <= 1e-2, gaps
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, atol=1e-5)


def test_grouped_expert_products_match_one_product_an_expert(cuda):
    """`torch._grouped_mm` over rows sorted by expert (two experts empty)
    at the published expert widths against one bf16 product an expert."""
    from ultrafnd_git_tpu_torch.models import lfm2

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3000, 2048, device=cuda, generator=g).to(torch.bfloat16)
    w = (0.02 * torch.randn(8, 3584, 2048, device=cuda, generator=g)).to(torch.bfloat16)
    offs = torch.tensor([100, 900, 900, 1500, 2000, 2999, 3000, 3000], dtype=torch.int32,
                        device=cuda)
    got, want = lfm2._grouped(x, w, offs), lfm2._per_expert(x, w, offs)
    assert float((got.float() - want.float()).abs().max()) <= 1e-2 * float(
        want.float().abs().max())
