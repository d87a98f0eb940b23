#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build, check and time its kernels, then
serve a full-width text-tower model through them.

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and nvcc.
Imports nothing of JAX. Phases, one line each; any failure exits non-zero:
  1. device  — nvidia-smi name and power limit, torch's device name, TF32 off;
  2. build   — nvcc builds every kernel from ultrafnd_git_tpu_torch/csrc;
  3. kernels — each kernel against its plain PyTorch version on the card at
     the shapes the serving path gives it (plus ragged S and fully masked
     rows), then both timed at the serving shape (CUDA events, median);
  4. slice   — a seeded full-width model (tower 768 x 2 layers x 6 heads,
     S = 64, vocab 32768, fusion 512, GCN 416-256-128, classifier 512 with
     a 6 x 4 NODE forest) over a synthetic corpus of N = 5376 answers three
     predict() requests (8, 64, 300 records, each sent five times after a
     warm-up) on the GPU; the kernel launch counts of that run
     must match the tower's depth times the chunks, and the same model on
     the CPU (plain attention) must agree within 1e-4 on prob_fake and
     the three forensic scalars;
  5. a JSON line of the kernels, then the JSON result line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

N_CORPUS = 5376  # FakeSV scale
OCR_VOCAB = 4096
TOKENS_PER_DOC = 12
REQUEST_SIZES = (8, 64, 300)  # 300 crosses the 256 bucket
REPEATS = 5  # each request is sent this many times; latency is the median
TOL = dict(atol=2e-5, rtol=2e-5)  # both sides full-f32 matmuls (TF32 off)
PROB_ATOL = 1e-4  # GPU vs CPU-plain, each served value
SERVING_SHAPE = (256, 6, 64, 128)
CHECK_SHAPES = (
    SERVING_SHAPE,
    (64, 6, 64, 128),  # the bucket of the 8- and 64-record requests
    (512, 6, 64, 128),  # the bucket of the 300-record request
    (8, 4, 64, 192),  # the test fixture's tower head width
    (4, 4, 100, 64),
    (4, 4, 512, 64),
    (2, 4, 2048, 64),
)
TOWER = dict(width=768, depth=2, heads=6, vocab_size=32768, max_len=64, gelu="tanh")
CJK_WORDS = ("外星人", "入侵", "地球", "警告", "辟谣", "谣言", "不实", "疫苗",
             "危险", "致命", "隐瞒", "专家", "证据", "科学", "视频", "记录")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a GPU")
    from ultrafnd_git_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", torch_name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    return dev


def phase_build():
    from ultrafnd_git_tpu_torch.kernels import _build, flash_attention as fa

    t0 = time.perf_counter()
    fa._kernel()  # nvcc -> build/torch_kernels, loaded with ctypes
    log("build", kernel="flash_attention_fwd", seconds=time.perf_counter() - t0,
        lib=_build.library_path("flash_attention_fwd").relative_to(REPO))


def _attention_inputs(shape, seed, dev):
    import torch

    b, h, s, d = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dev) for _ in range(3))
    lengths = torch.randint(0, s + 1, (b,), generator=g)
    lengths[0] = 0  # a fully masked row (an empty or padded record)
    if b > 1:
        lengths[1] = s
    mask = (torch.arange(s)[None] < lengths[:, None]).float().to(dev)
    return q, k, v, mask


def _median_ms(fn, runs=30, calls=10, warmup=5):
    """Median over `runs` of the per-call time of `calls` back-to-back calls
    (CUDA events around each block, so the device queue stays full)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def phase_kernels(dev):
    import torch

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

    max_err = 0.0
    with torch.inference_mode():
        for i, shape in enumerate(CHECK_SHAPES):
            q, k, v, mask = _attention_inputs(shape, i, dev)
            bias = fa.padding_bias(mask)
            out, lse = fa.flash_attention_fwd(q, k, v, bias)
            ref_out, ref_lse = fa.reference_attention(q, k, v, bias)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref_out, **TOL)
            torch.testing.assert_close(lse, ref_lse, **TOL)
            if not torch.isfinite(out).all():
                raise RuntimeError(f"non-finite kernel output at {shape}")
            err = max((out - ref_out).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            max_err = max(max_err, err)
            log("kernels", check="flash_attention_fwd", shape=shape, max_abs_err=err)
        q, k, v, mask = _attention_inputs(SERVING_SHAPE, 99, dev)
        bias = fa.padding_bias(mask)
        ms = _median_ms(lambda: fa.flash_attention_fwd(q, k, v, bias))
        plain_ms = _median_ms(lambda: fa.reference_attention(q, k, v, bias))
    log("kernels", time="flash_attention_fwd", shape=SERVING_SHAPE,
        ms=ms, plain_ms=plain_ms, timing="median of 30 blocks of 10 calls")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def synthetic_corpus(n, rng):
    """The cache contract at FakeSV scale: text 768, audio 128, visual 512,
    temporal 256, tower ids/mask (64), OCR sets from a 4096-token vocab."""
    from ultrafnd_git_tpu_torch.data.cache import TOWER_IDS_LEN, TOWER_VOCAB

    vocab = np.array([f"tok{i}" for i in range(OCR_VOCAB)])
    split = rng.permutation(n)
    k1, k2 = int(0.7 * n), int(0.85 * n)
    return {
        "ids": np.array([f"v{i}" for i in range(n)], dtype=object),
        "labels": rng.integers(0, 2, size=n).astype(np.int64),
        "text": rng.standard_normal((n, 768)).astype(np.float32),
        "audio": rng.standard_normal((n, 128)).astype(np.float32),
        "visual": rng.standard_normal((n, 512)).astype(np.float32),
        "temporal": rng.standard_normal((n, 256)).astype(np.float32),
        "aux": rng.uniform(size=(n, 2)).astype(np.float32),
        "text_ids": rng.integers(1, TOWER_VOCAB, size=(n, TOWER_IDS_LEN)).astype(np.int32),
        "text_mask": np.ones((n, TOWER_IDS_LEN), np.float32),
        "ocr_sets": [set(rng.choice(vocab, size=TOKENS_PER_DOC, replace=False))
                     for _ in range(n)],
        "split": (split[:k1], split[k1:k2], split[k2:]),
    }


def synthetic_records(count, corpus, rng):
    """Chinese titles and comments; half the records copy most of a corpus
    document's OCR tokens, so their graph rows link into the corpus."""
    recs = []
    for i in range(count):
        words = list(rng.choice(CJK_WORDS, size=int(rng.integers(2, 9))))
        ocr = list(rng.choice(CJK_WORDS, size=4))
        if i % 2 == 0:
            doc = sorted(corpus["ocr_sets"][int(rng.integers(len(corpus["ocr_sets"])))])
            ocr += doc[:8]
        recs.append({
            "video_id": f"req_{count}_{i}",
            "title": " ".join(words) + f" 第{i}期",
            "ocr": " ".join(ocr) if i % 5 else "",
            "comments": ["这是真的吗", "假的 别信"][: int(rng.integers(0, 3))],
        })
    return recs


def build_model_dir(root):
    """A full-width tower model with seeded weights (torch.Generator(0))
    over a synthetic FakeSV-scale corpus."""
    from ultrafnd_git_tpu_torch.serving import write_seeded_model_dir

    meta = {
        "cfg": {
            "train_text_tower": True,
            "text_tower_depth": TOWER["depth"],
            "text_tower_heads": TOWER["heads"],
            "tower_gelu": TOWER["gelu"],
            "use_gnn": True,
            "gnn_dim": 128,
            "gnn_overlap_thresh": 0.12,
            "hash_salt": "",
            "seed": 0,
        },
        "fusion": {"hidden": 512, "use_gnn": True, "gnn_dim": 128, "text_dim": 768,
                   "audio_dim": 128, "visual_dim": 512, "temporal_dim": 256},
        "classifier": {"hidden": 512, "num_classes": 2, "use_aux": True,
                       "aux_dim": 2, "node_trees": 6, "node_depth": 4,
                       "node_tau": 10.0, "temperature_init": 1.0},
        "gnn": {"in_dim": 416, "hid": 256, "out_dim": 128},
        "align": {"in_dim": 768, "out_dim": 256},
        "text_tower": TOWER,
    }
    corpus = synthetic_corpus(N_CORPUS, np.random.default_rng(0))
    write_seeded_model_dir(root, meta, corpus, seed=0)
    return corpus


def phase_slice(dev):
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
    from ultrafnd_git_tpu_torch.serving import FORENSIC_KEYS, Predictor

    with tempfile.TemporaryDirectory(prefix="chip_smoke_model_", dir=REPO / "build") as root:
        t0 = time.perf_counter()
        corpus = build_model_dir(root)
        rng = np.random.default_rng(1)
        requests = [synthetic_records(n, corpus, rng) for n in REQUEST_SIZES]
        t1 = time.perf_counter()
        gpu = Predictor(root, device="cuda")
        gpu.warmup(max(REQUEST_SIZES))  # every bucket the requests use
        t2 = time.perf_counter()
        log("slice", model_dir_s=t1 - t0, predictor_init_and_warmup_s=t2 - t1,
            corpus=N_CORPUS)
        try:
            fa.launches = 0  # count only the main path's run below
            rows, lat = [], []
            for recs in requests:
                times = []
                for _ in range(REPEATS):
                    s = time.perf_counter()
                    out = gpu.predict(recs)  # returns host floats: synchronised
                    times.append(time.perf_counter() - s)
                rows.append(out)
                lat.append(statistics.median(times))
            launches = fa.launches
        finally:
            gpu.close()
        chunks = len(REQUEST_SIZES) * REPEATS  # a request is one GPU chunk (<= 4096 rows)
        expect = TOWER["depth"] * chunks
        if launches != expect:
            raise RuntimeError(f"flash kernel launched {launches} times, expected {expect}")
        for recs, out in zip(requests, rows):
            p = np.array([r["prob_fake"] for r in out])
            if len(out) != len(recs) or not (np.isfinite(p).all() and (p >= 0).all()
                                              and (p <= 1).all()):
                raise RuntimeError("bad prob_fake values in a GPU response")
            if [r["id"] for r in out] != [r["video_id"] for r in recs]:
                raise RuntimeError("response ids do not match the request")
        for n, t in zip(REQUEST_SIZES, lat):
            log("slice", request=n, median_latency_ms=1e3 * t, records_per_s=n / t,
                repeats=REPEATS)

        cpu = Predictor(root, device="cpu")
        try:
            cpu_rows = [cpu.predict(recs) for recs in requests]
        finally:
            cpu.close()
        diffs = {}
        for key in ("prob_fake", *FORENSIC_KEYS):
            gpu_v, cpu_v = (
                np.concatenate([[r[key] for r in out] for out in rs])
                for rs in (rows, cpu_rows)
            )
            diffs[key] = float(np.max(np.abs(gpu_v - cpu_v)))
            if not diffs[key] <= PROB_ATOL:
                raise RuntimeError(f"GPU vs CPU-plain {key} differ by {diffs[key]}")
        all_p = np.concatenate([[r["prob_fake"] for r in out] for out in rows])
        log("slice", launches=launches, expected=expect,
            gpu_vs_cpu_max_abs=json.dumps(diffs, separators=(",", ":")),
            prob_min=float(all_p.min()), prob_max=float(all_p.max()),
            prob_std=float(all_p.std()))
    return launches


def main() -> int:
    dev = phase_device()
    import torch

    (REPO / "build").mkdir(exist_ok=True)
    phase_build()
    k2 = phase_kernels(dev)
    launches = phase_slice(dev)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ultrafnd_git_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "ultrafnd_git_tpu/kernels/flash_attention.py:68",
        "launches": launches,
        **k2,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
