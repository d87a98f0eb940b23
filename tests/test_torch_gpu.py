"""PyTorch port on a CUDA GPU: each kernel against its plain version, and
the serving path on the GPU against the same model on the CPU.

Every test here carries the `gpu` marker and skips with a reason where
torch.cuda is unavailable. The file imports no jax, so it also runs on a
GPU machine without it:
    python -m pytest --noconftest -o addopts="" tests/test_torch_gpu.py -q
Tolerances: kernel atol = rtol = 2e-5 (both sides full-f32 matmuls, TF32
off); tower atol 1e-5; served values atol 1e-4.
"""
import numpy as np
import pytest
import torch

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


def test_predictor_on_gpu_matches_cpu(cuda, tmp_path):
    from ultrafnd_git_tpu_torch.serving import Predictor, write_seeded_model_dir

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
    write_seeded_model_dir(str(tmp_path), meta, corpus)
    records = [{"video_id": f"r{i}", "title": f"标题 {i} 外星人 警告",
                "ocr": " ".join(sorted(corpus["ocr_sets"][i])) if i % 3 else "",
                "comments": ["这是真的吗"] * (i % 2)} for i in range(20)]
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
