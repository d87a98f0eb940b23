"""PyTorch port: serving a training out_dir directly, and the JAX CLIs'
command lines on the port's CLIs.

`Predictor(out_dir=O, checkpoint_name=slot)` reads the slot in memory with
`utils/transfer.trained_model`; its rows must equal, bit for bit, those of
the model directory `export_trained` writes from the same slot. The run is
trained by the port's own CLI on the CPU from the raw fixture root, with
run_train_eval.py's `--cpu --no_scan_epoch --no_fast_dropout_rng`, and is
then served through `predict`, `serve` and `export_serving` with
`--out_dir --checkpoint --cpu`, as the JAX scripts take them. No JAX here.
"""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ultrafnd_git_tpu_torch import export_serving, predict, serve, train
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.serving import Predictor
from ultrafnd_git_tpu_torch.utils.transfer import export_trained

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "tests" / "fixtures" / "fakesv_tiny"
FIXTURE = TINY / "data_complete.json"
JAX_FLAGS = ["--cpu", "--no_scan_epoch", "--no_fast_dropout_rng"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The train CLI on a run_train_eval.py command line: (out_dir, results,
    what it printed)."""
    out = tmp_path_factory.mktemp("outdir_run")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        results = train.main([
            "--data_root", str(TINY), "--out_dir", str(out), "--epochs", "2",
            "--batch_size", "8", "--seed", "0", "--train_text_tower",
            "--text_tower_depth", "1", "--text_tower_heads", "4", *JAX_FLAGS])
    yield str(out), results, said.getvalue()
    shutil.rmtree(out, ignore_errors=True)  # its slots are hundreds of MB


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Exports and artifacts of the tower model are hundreds of MB: drop each
    test's files when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def records():
    return load_records(FIXTURE)


def _rows(pred, records):
    try:
        return pred.predict(records)
    finally:
        pred.close()


def test_train_cli_takes_the_jax_flags(run):
    out, results, said = run
    assert "Device:          cpu" in said and "==== Final Results ====" in said
    assert all(np.isfinite(v) for v in results.values())
    for slot in ("best", "latest"):
        cfg = json.loads((Path(out) / slot / "meta.json").read_text())["cfg"]
        assert cfg["scan_epoch"] is False and cfg["fast_dropout_rng"] is False


@pytest.mark.parametrize("slot", ["best", "latest"])
def test_served_slot_equals_its_export(run, records, tmp_path, slot):
    out = run[0]
    direct = Predictor(out_dir=out, checkpoint_name=slot, device="cpu")
    model_dir = export_trained(out, slot, str(tmp_path / "model"))
    exported = Predictor(str(model_dir), device="cpu")
    assert direct.meta == exported.meta
    assert _rows(direct, records) == _rows(exported, records)


def test_predictor_source_rules(run, tmp_path):
    out = run[0]
    with pytest.raises(ValueError, match="exactly one"):
        Predictor(device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        Predictor(out, out_dir=out, device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint slot"):
        Predictor(out_dir=str(tmp_path / "empty"), device="cpu")
    jax_run = tmp_path / "jax_run"  # a JAX slot: an Orbax state/ directory
    (jax_run / "best" / "state").mkdir(parents=True)
    (jax_run / "best" / "meta.json").write_text(json.dumps({"cfg": {}}))
    with pytest.raises(ValueError, match=r"scripts/export_torch_model\.py"):
        Predictor(out_dir=str(jax_run), device="cpu")


@pytest.mark.parametrize("module,argv,message", [
    ("predict", ["--input", str(FIXTURE)], "exactly one of --model_dir / --artifact / --out_dir"),
    ("predict", ["--input", str(FIXTURE), "--model_dir", "M", "--out_dir", "O"],
     "exactly one of"),
    ("predict", ["--input", str(FIXTURE), "--artifact", "A", "--out_dir", "O"], "exactly one of"),
    ("predict", ["--input", str(FIXTURE), "--model_dir", "M", "--checkpoint", "latest"],
     "--checkpoint picks a slot of --out_dir"),
    ("serve", [], "exactly one of --model_dir / --artifact / --out_dir"),
    ("serve", ["--out_dir", "O", "--model_dir", "M"], "exactly one of"),
    ("serve", ["--artifact", "A", "--checkpoint", "latest"], "--checkpoint picks a slot"),
    ("export_serving", ["--artifact", "A"], "exactly one of --model_dir / --out_dir"),
    ("export_serving", ["--artifact", "A", "--model_dir", "M", "--out_dir", "O"],
     "exactly one of --model_dir / --out_dir"),
])
def test_cli_refuses_zero_or_two_model_sources(capsys, module, argv, message):
    entry = {"predict": predict.main, "serve": serve.parse_args,
             "export_serving": export_serving.main}[module]
    with pytest.raises(SystemExit) as exc:
        entry(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_predict_cli_serves_the_out_dir(run, records, tmp_path):
    out = run[0]
    dest = tmp_path / "rows.jsonl"
    predict.main(["--out_dir", out, "--checkpoint", "latest", "--input", str(FIXTURE),
                  "--output", str(dest), "--cpu"])
    rows = [json.loads(x) for x in dest.read_text().splitlines()]
    assert rows == _rows(Predictor(out_dir=out, checkpoint_name="latest", device="cpu"),
                         records)


def test_export_serving_cli_freezes_the_out_dir(run, records, tmp_path):
    out, art = run[0], tmp_path / "art"
    with contextlib.redirect_stdout(io.StringIO()):
        export_serving.main(["--out_dir", out, "--checkpoint", "latest", "--artifact", str(art),
                             "--platforms", "cpu", "--cpu"])
    dest = tmp_path / "rows.jsonl"
    predict.main(["--artifact", str(art), "--input", str(FIXTURE), "--output", str(dest),
                  "--cpu"])
    rows = [json.loads(x) for x in dest.read_text().splitlines()]
    ref = _rows(Predictor(out_dir=out, checkpoint_name="latest", device="cpu"), records)
    assert [r["id"] for r in rows] == [r["id"] for r in ref]
    np.testing.assert_allclose([r["prob_fake"] for r in rows], [r["prob_fake"] for r in ref],
                               atol=1e-6)


def test_serve_cli_serves_the_out_dir(run, records, tmp_path):
    """`serve --out_dir O --checkpoint latest --cpu` in a process of its own
    answers /predict with the library Predictor's rows."""
    out = run[0]
    code = f"""
import contextlib, io, json, re, threading, time, urllib.request
from ultrafnd_git_tpu_torch import serve
said = io.StringIO()
with contextlib.redirect_stdout(said):
    threading.Thread(target=serve.main, daemon=True, args=([
        "--out_dir", {out!r}, "--checkpoint", "latest", "--cpu", "--port", "0",
        "--warmup", "0"],)).start()
    for _ in range(600):
        m = re.search(r"on (http://[\\d.]+:\\d+)", said.getvalue())
        if m:
            break
        time.sleep(0.1)
from ultrafnd_git_tpu_torch.predict import load_records
records = load_records({str(FIXTURE)!r})[:16]
req = urllib.request.Request(m.group(1) + "/predict", data=json.dumps(
    {{"records": records}}).encode(), headers={{"Content-Type": "application/json"}})
print(json.dumps(json.loads(urllib.request.urlopen(req, timeout=120).read())))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])["predictions"]
    ref = _rows(Predictor(out_dir=out, checkpoint_name="latest", device="cpu"), records[:16])
    assert [r["id"] for r in got] == [r["id"] for r in ref]
    np.testing.assert_allclose([r["prob_fake"] for r in got], [r["prob_fake"] for r in ref],
                               atol=1e-5)
