"""PyTorch port, the legacy two-dispatch serving path (`fused_align=False`),
against the JAX package's.

The shared --train_text_tower checkpoint (`tower_ckpt`), exported for the
port with scripts/export_torch_model.py, is served on the CPU by both
packages' `Predictor(fused_align=False)`: featurize builds the full cache
(its align pass on the Predictor's device, with the checkpoint's align
MLP) and the legacy scoring program takes its temporal, aux and evidence.
Tolerances: prob_fake and the forensic scalars within 1e-4 of JAX's legacy
Predictor (bf16: 2e-2), the port's legacy rows within 1e-6 of its fused
rows (the same align module and arithmetic, split over two dispatches).
"""
import importlib.util
import json
import shutil
import threading
import urllib.request
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.server import make_server
from ultrafnd_git_tpu_torch.serving import Predictor

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
KEYS = ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity")
BATCH = 16


@pytest.fixture(autouse=True)
def _keep_salts():
    from ultrafnd_git_tpu.ops import hashing as jax_hashing

    prev = port_hashing.get_hash_salt(), jax_hashing.get_hash_salt()
    yield
    port_hashing.set_hash_salt(prev[0])
    jax_hashing.set_hash_salt(prev[1])


def _export_torch_model(out_dir, model_dir):
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.export(out_dir, model_dir)


@pytest.fixture(scope="module")
def exported(tower_ckpt, tmp_path_factory):
    model_dir = tmp_path_factory.mktemp("torch_model")
    _export_torch_model(tower_ckpt["out"], str(model_dir))
    yield str(model_dir)
    shutil.rmtree(model_dir, ignore_errors=True)


@pytest.fixture(scope="module")
def records():
    return load_records(FIXTURE)[:20]


def _assert_rows(ours, ref, atol):
    assert [r["id"] for r in ours] == [r["id"] for r in ref]
    for key in KEYS:
        a = np.array([r[key] for r in ours])
        b = np.array([r[key] for r in ref])
        assert np.abs(a - b).max() <= atol, (key, np.abs(a - b).max())


def _jax_rows(out_dir, records, **kw):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    return JaxPredictor(out_dir, batch_size=BATCH, fused_align=False, **kw).predict(records)


def _port_rows(model_dir, records, **kw):
    pred = Predictor(model_dir, batch_size=BATCH, device="cpu", **kw)
    try:
        return pred.predict(records)
    finally:
        pred.close()


@pytest.mark.parametrize("kw,atol", [
    pytest.param({}, 1e-4, id="f32"),
    pytest.param({"bf16": True}, 2e-2, id="bf16"),
    pytest.param({"sparse_graph": True}, 1e-4, id="sparse"),
])
def test_legacy_rows_match_jax_legacy_predictor(tower_ckpt, exported, records, kw, atol):
    ref = _jax_rows(tower_ckpt["out"], records, **kw)
    _assert_rows(_port_rows(exported, records, fused_align=False, **kw), ref, atol)


def test_legacy_rows_match_fused_rows(exported, records):
    legacy = _port_rows(exported, records, fused_align=False)
    _assert_rows(legacy, _port_rows(exported, records), 1e-6)


def test_featurize_runs_the_programs_align_module(exported, records):
    pred = Predictor(exported, batch_size=BATCH, device="cpu", fused_align=False)
    try:
        assert pred._encoders["tsync"].module is pred.score_modules["align"]
        feats = pred.featurize(records[:3])
        assert {"temporal", "aux"} <= set(feats) and "emo" not in feats
        assert feats["temporal"].shape == (8, 256)  # the featurize bucket
        pred.predict(records[:3])
        assert set(pred._programs) == {False}
    finally:
        pred.close()


def test_a_cache_picks_its_program_whatever_the_default(exported, records):
    """A full cache sent to a fused Predictor takes the legacy program, a
    host-only one sent to a legacy Predictor the fused program (JAX
    `serving.py:566-576`, `:864-868`)."""
    fused = Predictor(exported, batch_size=BATCH, device="cpu")
    legacy = Predictor(exported, batch_size=BATCH, device="cpu", fused_align=False)
    try:
        n = 11
        full = legacy.featurize(records[:n])
        host = fused.featurize(records[:n])
        assert "temporal" in full and "temporal" not in host
        a = fused.predict_featurized(full, n)
        assert set(fused._programs) == {False}
        _assert_rows(a, legacy.predict_featurized(full, n), 0.0)
        b = legacy.predict_featurized(host, n)
        assert set(legacy._programs) == {False, True}
        _assert_rows(b, fused.predict_featurized(host, n), 0.0)
        _assert_rows(a, b, 1e-6)
    finally:
        fused.close()
        legacy.close()


def test_legacy_explain_grad_matches_fused(exported, records):
    preds = [Predictor(exported, batch_size=BATCH, device="cpu", fused_align=f)
             for f in (False, True)]
    try:
        ours, ref = (p.explain(records[:12], method="grad", top_k=512) for p in preds)
    finally:
        for p in preds:
            p.close()
    for o, r in zip(ours, ref):
        vo, vr = (np.array([v for _, v in sorted(x["explain"]["top_fused_dims"])]
                           + [x["explain"]["aux"]["temporal_delay"],
                              x["explain"]["aux"]["emotion"]]) for x in (o, r))
        assert np.abs(vo - vr).max() <= 1e-5 * np.abs(vr).max()
        assert abs(o["prob_fake"] - r["prob_fake"]) <= 1e-6


def test_http_batcher_serves_a_legacy_predictor(exported, records):
    pred = Predictor(exported, batch_size=4, device="cpu", fused_align=False)
    server = make_server(pred, port=0, batch_window_ms=20.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    out = {}

    def call(i):
        req = urllib.request.Request(url, data=json.dumps({"records": [records[i]]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out[i] = json.loads(resp.read())["predictions"][0]

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        direct = pred.predict(records[:8])
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        thread.join(timeout=5)
        pred.close()
    _assert_rows([out[i] for i in range(8)], direct, 1e-6)
    assert server.batcher.records == 8


@pytest.fixture(scope="module")
def evidence_dirs(fixture_data_root, tmp_path_factory):
    """A JAX use_evidence out_dir (the trainer's initial weights as its best
    slot) and the port's export of it."""
    from ultrafnd_git_tpu.training import checkpoint as jax_ckpt
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig

    out = tmp_path_factory.mktemp("jax_evidence")
    cfg = TrainConfig(data_root=fixture_data_root, out_dir=str(out), batch_size=8, epochs=1,
                      seed=0, log_metrics_jsonl=False, use_evidence=True)
    jt = ForensicTrainer(cfg)
    jax_ckpt.save_checkpoint(str(out), "best", jt.state,
                             {"trainer": "v2", "epoch": 1, "best_val_auc": 0.5,
                              "no_improve": 0, "cfg": asdict(cfg)})
    jax_ckpt.wait_for_writes()
    model = tmp_path_factory.mktemp("torch_evidence")
    _export_torch_model(str(out), str(model))
    yield str(out), str(model)
    for root in (out, model):
        shutil.rmtree(root, ignore_errors=True)


def test_evidence_legacy_rows_match_jax(evidence_dirs, records):
    ref = _jax_rows(evidence_dirs[0], records)
    ours = _port_rows(evidence_dirs[1], records, fused_align=False)
    _assert_rows(ours, ref, 1e-4)
    _assert_rows(ours, _port_rows(evidence_dirs[1], records), 1e-6)
