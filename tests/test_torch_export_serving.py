"""PyTorch port, the frozen scoring artifact, against the JAX package's.

The shared --train_text_tower checkpoint (`tower_ckpt`) is exported for the
port with scripts/export_torch_model.py. On each lever, the JAX package
freezes its Predictor with `export_serving.export_artifact(platforms=
("cpu",))` and the port freezes its own with `torch.export`; both artifacts
serve the same records on the CPU. Tolerances: prob_fake and the forensic
scalars within 1e-4 of JAX's artifact (bf16: 2e-2, the envelope of the
bf16 levers; int8: the port's artifact within 1e-4 of the port's own live
int8 Predictor, whose agreement with JAX's quantize_tree is
test_torch_quant.py's), and within 1e-6 of the port's live Predictor on
the same device (on the CPU the rows are bit-identical, and the test says
so). An
evidence checkpoint (initial weights of a JAX evidence trainer) and the
sparse graph layout are served too.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch import export_serving as es
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.serving import Predictor

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
KEYS = ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity")
LEVERS = {"f32": {}, "bf16": {"bf16": True}, "int8": {"quantize": True}}
VS_JAX = {"f32": 1e-4, "bf16": 2e-2}
VS_LIVE = 1e-6
BATCH = 16


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Artifacts of the tower model are about 160 MB each: drop each test's
    files when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


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
    return load_records(FIXTURE)[:20]  # a full chunk of 16 and a ragged one


def _jax_artifact_rows(out_dir, path, records, **kw):
    from ultrafnd_git_tpu.export_serving import ExportedPredictor as JaxExported
    from ultrafnd_git_tpu.export_serving import export_artifact as jax_export
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    jax_export(JaxPredictor(out_dir, batch_size=BATCH, **kw), str(path), platforms=("cpu",))
    return JaxExported(str(path), batch_size=BATCH).predict(records)


def _port_rows(model_dir, path, records, **kw):
    """(live rows, artifact rows) of the port on the CPU."""
    live = Predictor(model_dir, batch_size=BATCH, device="cpu", **kw)
    try:
        rows = live.predict(records)
        es.export_artifact(live, str(path), platforms=("cpu",))
    finally:
        live.close()
    art = es.ExportedPredictor(str(path), device="cpu")
    try:
        return rows, art.predict(records)
    finally:
        art.close()


def _assert_rows(ours, ref, atol):
    assert [r["id"] for r in ours] == [r["id"] for r in ref]
    for key in KEYS:
        a = np.array([r[key] for r in ours])
        b = np.array([r[key] for r in ref])
        assert np.abs(a - b).max() <= atol, (key, np.abs(a - b).max())


@pytest.fixture(scope="module")
def served(tower_ckpt, exported, records, tmp_path_factory):
    """{lever: (JAX artifact rows or None, port live rows, port artifact rows,
    port artifact dir, JAX artifact dir)}."""
    out = {}
    for name, kw in LEVERS.items():
        root = tmp_path_factory.mktemp(f"art_{name}")
        jax_rows = None
        if name in VS_JAX:
            jax_rows = _jax_artifact_rows(tower_ckpt["out"], root / "jax", records, **kw)
        live, art = _port_rows(exported, root / "port", records, **kw)
        out[name] = (jax_rows, live, art, root / "port", root / "jax")
    yield out
    for *_, port, jax_dir in out.values():
        shutil.rmtree(port.parent, ignore_errors=True)


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_artifact_matches_jax_artifact_and_live_rows(served, lever):
    jax_rows, live, art, _, _ = served[lever]
    _assert_rows(art, live, VS_LIVE)
    assert art == live  # on the CPU the frozen program gives the live bits
    if jax_rows is not None:
        _assert_rows(art, jax_rows, VS_JAX[lever])
        for o, r in zip(art, jax_rows):
            if abs(r["prob_fake"] - 0.5) > VS_JAX[lever]:
                assert o["label"] == r["label"]


def test_artifact_files_and_meta(served, exported):
    root = served["f32"][3]
    assert sorted(p.name for p in root.iterdir()) == sorted(es.FILES)
    meta = json.loads((root / "meta.json").read_text())
    assert meta["format"] == es.FORMAT and meta["platforms"] == ["cpu"]
    assert meta["fused_align"] and meta["tower_len"] == 64
    assert meta["feats_keys"] == ["audio", "emo", "text", "visual"]
    with np.load(root / "arrays.npz") as z:
        assert set(z.files) == {"corpus_deg", "corpus_sizes", "ocr_tok", "ocr_doc"}
    assert json.loads((served["int8"][3] / "meta.json").read_text())["quantize"]


def test_program_holds_the_op_and_no_device(served):
    """The frozen program calls K2's op by name, carries the weights once,
    and holds no device of its own: moved to another device type (here
    "meta"), it runs there at a new batch size."""
    from torch.export.passes import move_to_device_pass

    for lever, op in (("f32", "ufnd.flash_attention_fwd.default"),
                      ("bf16", "ufnd.flash_attention_fwd_bf16.default")):
        ep = torch.export.load(str(served[lever][3] / "scorer.pt2"))
        targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        assert targets.count(op) == 1  # depth 1
        assert any(k.startswith("text_tower.") for k in ep.state_dict)
        ep = move_to_device_pass(ep, "meta")
        example = ep.example_inputs[0][0]
        x = {k: torch.empty((3,) + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
             for k, v in example.items()}
        probs, forensic, fused, aux = ep.module()(x)
        assert probs.shape == (3, 2) and forensic.shape == (3, 3) and aux.shape == (3, 2)
        assert probs.device.type == "meta"


def test_artifact_serves_after_move_without_the_model_dir(exported, records, tmp_path):
    model = tmp_path / "model"
    shutil.copytree(exported, model)
    live = Predictor(str(model), batch_size=BATCH, device="cpu")
    rows = live.predict(records)
    es.export_artifact(live, str(tmp_path / "a"), platforms=("cpu",))
    live.close()
    shutil.rmtree(model)
    shutil.move(str(tmp_path / "a"), str(tmp_path / "moved"))
    art = es.ExportedPredictor(str(tmp_path / "moved"), batch_size=8, device="cpu")
    try:
        assert art.warmup(16) == 2
        _assert_rows(art.predict(records), rows, VS_LIVE)
    finally:
        art.close()


def test_chunks_are_capped_at_batch_size(served, exported, records, monkeypatch):
    """On a GPU the live Predictor's chunks grow to 4096 rows; the
    artifact's stay at batch_size, as JAX's (`_fixed_shape_dispatch`)."""
    art = es.ExportedPredictor(str(served["f32"][3]), batch_size=8, device="cpu")
    live = Predictor(exported, batch_size=8, device="cpu")
    counts = []
    real = art._score_chunk
    monkeypatch.setattr(art, "_score_chunk", lambda f, n, *a: counts.append(n) or real(f, n, *a))
    art.predict(records)
    assert counts == [8, 8, 4]
    for pred in (art, live):
        monkeypatch.setattr(pred, "device", torch.device("cuda"))
    assert art._max_chunk_rows() == 8 and live._max_chunk_rows() == 4096


@pytest.mark.parametrize("field,value,match", [
    ("feats_keys", ["audio", "text", "visual"], "feature spec"),
    ("tower_len", 32, "tower token length"),
    ("platforms", ["cuda"], "exported for"),
])
def test_contract_checks_raise(served, tmp_path, field, value, match):
    root = tmp_path / "a"
    shutil.copytree(served["f32"][3], root)
    meta = json.loads((root / "meta.json").read_text())
    meta[field] = value
    (root / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=match):
        es.ExportedPredictor(str(root), device="cpu")


def test_jax_artifact_is_refused_by_format(served):
    with pytest.raises(ValueError, match="ultrafnd-serving-artifact/1") as err:
        es.ExportedPredictor(str(served["f32"][4]), device="cpu")
    assert es.FORMAT in str(err.value)


def test_explain_and_the_other_contract_raise(served, records):
    art = es.ExportedPredictor(str(served["f32"][3]), device="cpu")
    with pytest.raises(NotImplementedError, match="full-precision"):
        art.explain(records[:2])
    full = {"temporal": None}  # a full cache asks for the legacy contract
    with pytest.raises(ValueError, match="fused_align=True"):
        art.predict_featurized(full, 1)


def test_sparse_predictor_exports_dense_rows_like_jax(tower_ckpt, exported, records, tmp_path):
    jax_rows = _jax_artifact_rows(tower_ckpt["out"], tmp_path / "jax", records,
                                  sparse_graph=True)
    live, art = _port_rows(exported, tmp_path / "port", records, sparse_graph=True)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert "a_rows" in meta["input_keys"] and "link_idx" not in meta["input_keys"]
    _assert_rows(art, jax_rows, 1e-4)
    _assert_rows(art, live, 1e-5)  # dense rows against the live lists: another sum order


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


def test_evidence_artifact_matches_jax(evidence_dirs, records, tmp_path):
    jax_rows = _jax_artifact_rows(evidence_dirs[0], tmp_path / "jax", records)
    live, art = _port_rows(evidence_dirs[1], tmp_path / "port", records)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["use_evidence"] and "evidence_host" in meta["feats_keys"]
    assert meta["tower_len"] is None
    _assert_rows(art, jax_rows, 1e-4)
    _assert_rows(art, live, VS_LIVE)


def test_legacy_contract_artifact_carries_its_align(exported, records, tmp_path):
    live, art = _port_rows(exported, tmp_path / "port", records, fused_align=False)
    with np.load(tmp_path / "port" / "arrays.npz") as z:
        assert any(k.startswith("align:") for k in z.files)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert not meta["fused_align"] and "temporal" in meta["feats_keys"]
    _assert_rows(art, live, VS_LIVE)


def _cli(args, expect_rc):
    code = (
        "import sys, runpy\n"
        "mod = sys.argv[1]\n"
        "sys.argv = [mod] + sys.argv[2:]\n"
        "try:\n"
        "    runpy.run_module(mod, run_name='__main__')\n"
        "finally:\n"
        "    print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'ultrafnd_git_tpu')), flush=True)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    run = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=600)
    assert run.returncode == expect_rc, (run.stdout[-2000:], run.stderr[-2000:])
    assert "LOADED []" in run.stdout
    return run


def test_cli_exports_and_serves_the_artifact_without_jax(exported, served, tmp_path):
    art = tmp_path / "cli_art"
    run = _cli(["ultrafnd_git_tpu_torch.export_serving", "--model_dir", exported,
                "--artifact", str(art), "--platforms", "cpu", "--device", "cpu",
                "--batch_size", str(BATCH)], 0)
    assert "scorer.pt2" in run.stdout and "arrays.npz" in run.stdout
    assert "meta.json" in run.stdout
    out = tmp_path / "rows.jsonl"
    _cli(["ultrafnd_git_tpu_torch.predict", "--artifact", str(art), "--input", str(FIXTURE),
          "--device", "cpu", "--output", str(out)], 0)
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    ref = Predictor(exported, batch_size=BATCH, device="cpu").predict(load_records(FIXTURE))
    _assert_rows(rows, ref, VS_LIVE)


@pytest.mark.parametrize("module,extra,message", [
    ("predict", ["--input", str(FIXTURE)], "exactly one of --model_dir / --artifact"),
    ("predict", ["--input", str(FIXTURE), "--artifact", "A", "--model_dir", "M"],
     "exactly one of --model_dir / --artifact"),
    ("predict", ["--input", str(FIXTURE), "--artifact", "A", "--bf16"], "fixed at export"),
    ("predict", ["--input", str(FIXTURE), "--artifact", "A", "--quantize"],
     "fixed at export"),
    ("predict", ["--input", str(FIXTURE), "--artifact", "A", "--explain"],
     "full-precision"),
    ("serve", [], "exactly one of --model_dir / --artifact"),
    ("serve", ["--artifact", "A", "--bf16"], "fixed at export"),
    ("serve", ["--artifact", "A", "--quantize"], "fixed at export"),
    ("export_serving", ["--model_dir", "M"], "--artifact"),
])
def test_cli_argument_rules(module, extra, message):
    run = _cli([f"ultrafnd_git_tpu_torch.{module}", *extra], 2)
    assert message in run.stderr
