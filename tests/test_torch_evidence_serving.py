"""PyTorch port: serving a `--use_evidence` checkpoint against the JAX
Predictor.

A JAX out_dir trained with use_evidence and the text tower (depth 1, 4
heads) on `fakesv_tiny` is exported by scripts/export_torch_model.py and
served by the port on the CPU: the fusion gates read [semantic gap,
emotion intensity] from featurize and the delay from the scoring program
(JAX `serving.py:525-527`). prob_fake and the forensic scalars agree with
the JAX Predictor within 1e-4 (int8: against the JAX int8 Predictor;
bf16: within the 2e-2 envelope of the JAX bf16 Predictor), explain("grad")
within 1e-4 of the largest attribution, and the sparse graph layout and
the HTTP batcher's featurize / predict_featurized split give the f32 rows.
"""
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.serving import FORENSIC_KEYS, Predictor

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
KEYS = ("prob_fake", *FORENSIC_KEYS)


@pytest.fixture(scope="module")
def evidence_ckpt(fixture_data_root, tmp_path_factory):
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig

    out = tmp_path_factory.mktemp("evidence_ckpt")
    ForensicTrainer(TrainConfig(
        data_root=fixture_data_root, out_dir=str(out), batch_size=8, epochs=1, seed=0,
        log_metrics_jsonl=False, use_evidence=True, train_text_tower=True,
        text_tower_depth=1, text_tower_heads=4)).fit()
    yield str(out)
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def exported(evidence_ckpt, tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("evidence_model")
    mod.export(evidence_ckpt, str(out))
    yield str(out)
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def records():
    recs = load_records(FIXTURE)
    # request records the corpus never saw, one of them empty
    return recs + [{"video_id": "new_0", "title": "外星人 入侵 警告 危险", "ocr": "辟谣 科学 证据",
                    "comments": ["假的"]}, {"video_id": "new_1"}]


@pytest.fixture(scope="module")
def jax_predictor(evidence_ckpt):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    return JaxPredictor(evidence_ckpt)


def _serve(model_dir, records, **kw):
    pred = Predictor(model_dir, device="cpu", **kw)
    try:
        return pred.predict(records)
    finally:
        pred.close()


def _assert_rows_match(ours, ref, atol=1e-4):
    assert [r["id"] for r in ours] == [r["id"] for r in ref]
    for key in KEYS:
        np.testing.assert_allclose([r[key] for r in ours], [r[key] for r in ref], atol=atol,
                                   rtol=0, err_msg=key)
    for o, r in zip(ours, ref):
        if abs(r["prob_fake"] - 0.5) > atol:
            assert o["label"] == r["label"], (o, r)
        assert list(o) == list(r)


def test_export_carries_the_evidence_checkpoint(exported):
    meta = json.loads((Path(exported) / "meta.json").read_text())
    assert meta["cfg"]["use_evidence"] is True
    assert meta["text_tower"]["depth"] == 1


def test_port_predictor_serves_evidence_as_jax(exported, records, jax_predictor):
    ref = jax_predictor.predict(records)
    ours = _serve(exported, records)
    _assert_rows_match(ours, ref)
    # the gates read the scorers, not the internal proxies: the served
    # semantic_conflict and emotion_intensity are the host evidence columns
    pred = Predictor(exported, device="cpu")
    try:
        feats = pred.featurize(records)
    finally:
        pred.close()
    assert feats["evidence_host"].shape == (128, 2)  # the power-of-two bucket
    np.testing.assert_array_equal([r["semantic_conflict"] for r in ours],
                                  feats["evidence_host"][:len(records), 0])
    np.testing.assert_array_equal([r["emotion_intensity"] for r in ours],
                                  feats["evidence_host"][:len(records), 1])


def test_explain_grad_of_an_evidence_checkpoint_matches_jax(exported, records, jax_predictor):
    ref = jax_predictor.explain(records[:8], method="grad", top_k=512)
    pred = Predictor(exported, device="cpu")
    try:
        ours = pred.explain(records[:8], method="grad", top_k=512)
        shap = pred.explain(records[:2], method="shap", top_k=4, n_coalitions=64,
                            background_size=8)
    finally:
        pred.close()

    def vector(row):
        e = row["explain"]
        v = np.zeros(514)
        for d, x in e["top_fused_dims"]:
            v[d] = x
        v[512:] = e["aux"]["temporal_delay"], e["aux"]["emotion"]
        return v

    vo = np.stack([vector(r) for r in ours])
    vr = np.stack([vector(r) for r in ref])
    assert np.abs(vo - vr).max() <= 1e-4 * np.abs(vr).max()
    _assert_rows_match([{k: v for k, v in r.items() if k != "explain"} for r in ours],
                       [{k: v for k, v in r.items() if k != "explain"} for r in ref])
    for row in shap:  # the background carries the corpus rows' evidence
        e = row["explain"]
        total = e["base_value"] + e["fused_signed_sum"] + sum(e["aux"].values())
        assert e["method"] == "kernel-shap" and abs(total - row["prob_fake"]) <= 1e-5


@pytest.mark.parametrize("levers", [{"quantize": True}, {"bf16": True}], ids=["int8", "bf16"])
def test_levers_pass_the_evidence_through(exported, evidence_ckpt, records, levers):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    ref = JaxPredictor(evidence_ckpt, **levers).predict(records)
    ours = _serve(exported, records, **levers)
    if levers.get("bf16"):
        assert [r["id"] for r in ours] == [r["id"] for r in ref]
        assert np.abs(np.array([r["prob_fake"] for r in ours])
                      - [r["prob_fake"] for r in ref]).max() <= 2e-2
        f32 = _serve(exported, records)
        for key in ("semantic_conflict", "emotion_intensity"):  # the f32 host columns
            np.testing.assert_array_equal([r[key] for r in ours], [r[key] for r in f32])
    else:
        _assert_rows_match(ours, ref)


def test_sparse_graph_and_batcher_split_give_the_f32_rows(exported, records):
    dense = _serve(exported, records)
    sparse = _serve(exported, records, sparse_graph=True)
    _assert_rows_match(sparse, dense, atol=1e-5)
    pred = Predictor(exported, device="cpu", batch_size=128)
    try:
        split = pred.predict_featurized(pred.featurize(records), len(records))
    finally:
        pred.close()
    _assert_rows_match(split, dense, atol=1e-5)
