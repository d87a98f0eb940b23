"""PyTorch port, the slice as a whole: the port's Predictor against the JAX
Predictor on the shared --train_text_tower checkpoint.

The checkpoint is exported with scripts/export_torch_model.py and served
by the port on the CPU (its plain attention path). prob_fake and the three
forensic scalars agree to atol 1e-4; ids are identical; labels are
identical wherever |p - 0.5| > 1e-4.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.serving import Predictor

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
KEYS = ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity")


def _export_fn():
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.export


@pytest.fixture(scope="module")
def exported(tower_ckpt, tmp_path_factory):
    model_dir = tmp_path_factory.mktemp("torch_model")
    _export_fn()(tower_ckpt["out"], str(model_dir))
    return str(model_dir)


@pytest.fixture(scope="module")
def records():
    return load_records(FIXTURE)


@pytest.fixture(scope="module")
def jax_rows(tower_ckpt, records):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    return JaxPredictor(tower_ckpt["out"]).predict(records)


def _assert_rows_match(ours, ref):
    assert [r["id"] for r in ours] == [r["id"] for r in ref]
    for key in KEYS:
        np.testing.assert_allclose(
            [r[key] for r in ours], [r[key] for r in ref], atol=1e-4, err_msg=key
        )
    for o, r in zip(ours, ref):
        if abs(r["prob_fake"] - 0.5) > 1e-4:
            assert o["label"] == r["label"], (o, r)
        assert list(o) == list(r)  # same JSONL row keys, same order


def test_export_writes_model_dir(exported, tower_ckpt):
    meta = json.loads((Path(exported) / "meta.json").read_text())
    assert meta["text_tower"]["depth"] == 1 and meta["text_tower"]["heads"] == 4
    assert meta["cfg"]["train_text_tower"] is True
    weights = torch.load(Path(exported) / "weights.pt", weights_only=True)
    assert set(weights) == {"fusion", "clf", "gnn", "text_tower", "align"}
    assert (Path(exported) / "feature_cache.npz").exists()


def test_port_predictor_matches_jax_predictor(exported, records, jax_rows):
    pred = Predictor(exported, device="cpu")
    try:
        before = fa.launches
        rows = pred.predict(records)
        assert fa.launches == before == 0  # the CPU path launches no kernel
    finally:
        pred.close()
    assert len(rows) == len(records) == 64
    _assert_rows_match(rows, jax_rows)
    assert 0 < sum(r["label"] for r in rows) < len(rows)


def test_multi_chunk_request(exported, records, jax_rows):
    """batch_size=8 cuts 20 records into 3 chunks; rows match the JAX
    single-chunk scores, and fallback ids stay request-global."""
    pred = Predictor(exported, batch_size=8, device="cpu")
    try:
        rows = pred.predict(records[:20])
        anon = pred.predict([{k: v for k, v in r.items() if k != "video_id"}
                             for r in records[:20]])
        assert pred.warmup(16) == 2
    finally:
        pred.close()
    _assert_rows_match(rows, jax_rows[:20])
    assert [r["id"] for r in anon] == [f"q_{i}" for i in range(20)]
    np.testing.assert_allclose([r["prob_fake"] for r in anon],
                               [r["prob_fake"] for r in rows], atol=1e-6)


def test_predict_cli_loads_no_jax(exported, tmp_path):
    """The port imports no jax and nothing of the JAX package: a fresh
    process runs the predict CLI on the CPU and then checks sys.modules."""
    out = tmp_path / "preds.jsonl"
    code = (
        "import sys\n"
        "from ultrafnd_git_tpu_torch.predict import main\n"
        f"main(['--model_dir', {exported!r}, '--input', {str(FIXTURE)!r},"
        f" '--output', {str(out)!r}, '--device', 'cpu', '--batch_size', '16'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ultrafnd_git_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(rows) == 64 and set(rows[0]) == {
        "id", "prob_fake", "label", *KEYS[1:]
    }


def test_cuda_without_gpu_raises(exported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(exported)  # device="cuda" is the default
    from ultrafnd_git_tpu_torch.predict import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model_dir", exported, "--input", str(FIXTURE)])


@pytest.mark.parametrize("kwargs", [{"serve_dp": 2}], ids=["serve_dp"])
def test_unported_options_raise(exported, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Predictor(exported, device="cpu", **kwargs)


@pytest.mark.parametrize("use_gnn", [False, True])
def test_seeded_model_without_tower_serves(tmp_path, use_gnn):
    """A checkpoint without the tower scores its hash text features; with
    use_gnn=False no corpus graph is built at all (the JAX Predictor builds
    a dense (N, N) one there for nothing)."""
    from ultrafnd_git_tpu_torch.serving import write_seeded_model_dir

    meta = {
        "cfg": {"use_gnn": use_gnn},
        "fusion": {"hidden": 32, "use_gnn": use_gnn, "gnn_dim": 8, "text_dim": 768,
                   "audio_dim": 128, "visual_dim": 512, "temporal_dim": 256},
        "classifier": {"hidden": 16, "num_classes": 2, "use_aux": True, "aux_dim": 2,
                       "node_trees": 2, "node_depth": 2, "node_tau": 10.0,
                       "temperature_init": 1.0},
        "gnn": {"in_dim": 416, "hid": 16, "out_dim": 8},
        "align": {"in_dim": 768, "out_dim": 256},
        "text_tower": None,
    }
    rng = np.random.default_rng(0)
    n = 30
    corpus = {
        "ids": np.array([f"c{i}" for i in range(n)], dtype=object),
        "labels": np.zeros(n, np.int64),
        **{k: rng.standard_normal((n, w)).astype(np.float32) for k, w in
           (("text", 768), ("audio", 128), ("visual", 512), ("temporal", 256),
            ("aux", 2), ("evidence", 3))},
        "text_ids": np.zeros((n, 64), np.int32),
        "text_mask": np.zeros((n, 64), np.float32),
        "ocr_sets": [{f"w{i % 7}", f"w{i % 5}"} for i in range(n)],
        "split": (np.arange(n), np.arange(0), np.arange(0)),
    }
    write_seeded_model_dir(str(tmp_path), meta, corpus)
    pred = Predictor(str(tmp_path), device="cpu")
    try:
        rows = pred.predict([{"title": "外星人 警告", "ocr": "w1 w2"}, {}])
        assert hasattr(pred, "XG") == use_gnn
        feats = pred.featurize([{"title": "外星人 警告"}])
        assert "text_ids" not in feats  # no tower: no tokenization either
    finally:
        pred.close()
    assert [r["id"] for r in rows] == ["q_0", "q_1"]
    assert all(0.0 <= r["prob_fake"] <= 1.0 for r in rows)


@pytest.mark.parametrize("salt", ["", "salted"])
def test_featurizer_matches_jax_cache_builder(records, salt):
    """The port's host featurizer equals the JAX serving featurizer
    (build_feature_cache with_align=False, with_evidence=False) exactly."""
    from ultrafnd_git_tpu.data.cache import build_feature_cache, make_encoders
    from ultrafnd_git_tpu.ops.hashing import get_hash_salt, set_hash_salt
    from ultrafnd_git_tpu_torch.data.featurize import featurize_records
    from ultrafnd_git_tpu_torch.ops import hashing as port_hashing

    recs = records[:24] + [{}, {"title": "", "comments": None}]

    class Raw:
        def __len__(self):
            return len(recs)

        def get_item(self, i):
            r = recs[i]
            return {"id": r.get("video_id") or r.get("id") or f"q_{i}",
                    "title": r.get("title") or "", "ocr": r.get("ocr") or "",
                    "comments": list(r.get("comments") or []), "label": 0}

    prev = get_hash_salt(), port_hashing.get_hash_salt()
    try:
        set_hash_salt(salt)  # each package keeps its own process-wide salt
        port_hashing.set_hash_salt(salt)
        ref = build_feature_cache(Raw(), encoders=make_encoders(seed=0, with_evidence=False),
                                  with_evidence=False, with_align=False)
        ours = featurize_records(recs)
    finally:
        set_hash_salt(prev[0])
        port_hashing.set_hash_salt(prev[1])
    assert list(ours["ids"]) == list(ref["ids"])
    for key in ("text", "audio", "visual", "emo", "text_ids", "text_mask"):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
        assert ours[key].dtype == ref[key].dtype, key
    assert ours["ocr_sets"] == ref["ocr_sets"]
