"""PyTorch port, reference-checkpoint migration (`import_reference` and
`export_reference`) against the JAX package's, on the shared v2_ckpt.

The JAX package's own export (`scripts/export_reference_checkpoint.py`,
over `best_pt_state_dicts_from_v2_params`) writes v2_ckpt's `best` slot as
a reference best.pt. The port imports it with --device cpu over the
fixture, taking the cache and align weights of v2_ckpt's model directory
(`scripts/export_torch_model.py`), so that the slot is served on JAX's
corpus: `Predictor(out_dir=O)` gives prob_fake within 1e-4 of the JAX
Predictor. The port's export of the imported slot equals the file it came
from tensor for tensor (torch.equal, dtype and shape), JAX's
`v2_params_from_best_pt` reads it back to v2_ckpt's params exactly, and its
cfg has the JAX export's keys. Both CLIs run in one fresh process, which
loads no module of jax or of the JAX package. The refusals (a non-v2
slot, a JAX Orbax slot, a payload without clf, a gnn_dim mismatch) exit 2;
--resume on the imported latest slot fine-tunes from epoch 1 through K1's
plain version; the import runs on cuda unless asked for the CPU;
--verify's plumbing runs on a stand-in reference tree.
"""
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch import export_reference, import_reference
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.serving import Predictor

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny"
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs small tensors, which one thread computes faster
    than a pool that parallel test workers oversubscribe; the previous
    count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _said(fn, *args):
    """(fn's return value, what it printed)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def migrated(v2_ckpt, tmp_path_factory):
    """v2_ckpt as a reference best.pt (JAX's export), its model directory,
    and the port's import and re-export, both CLIs in one fresh process."""
    root = tmp_path_factory.mktemp("migration")
    best_pt = root / "ref" / "best.pt"
    jax_payload = _script("export_reference_checkpoint").export_slot(v2_ckpt, "best",
                                                                      str(best_pt))
    model_dir = root / "model"
    _script("export_torch_model").export(v2_ckpt, str(model_dir))
    out, back = root / "imported", root / "back" / "best.pt"
    code = (
        "import json, sys\n"
        "from ultrafnd_git_tpu_torch import export_reference, import_reference\n"
        f"rc = [import_reference.main({[str(best_pt), '--data_root', str(FIXTURE), '--out_dir', str(out), '--model_dir', str(model_dir), '--cpu']!r}),\n"
        f"      export_reference.main({['--out_dir', str(out), '--dest', str(back)]!r})]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ultrafnd_git_tpu'))\n"
        "print('RESULT ' + json.dumps([rc, bad]))\n"
    )
    env = {**os.environ, "ULTRAFND_DISABLE_HF": "1", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rc, bad = json.loads(proc.stdout.split("RESULT ")[-1])
    yield {"jax_payload": jax_payload, "best_pt": best_pt, "model_dir": model_dir, "out": out,
           "back": back, "rc": rc, "loaded": bad, "said": proc.stdout}
    shutil.rmtree(root, ignore_errors=True)


def test_both_clis_run_without_jax(migrated):
    assert migrated["rc"] == [0, 0], migrated["said"][-2000:]
    assert migrated["loaded"] == []
    said = migrated["said"]
    assert "feature cache: taking" in said and "(fusion+clf+gnn)" in said
    for slot in ("best", "latest"):
        meta = json.loads((migrated["out"] / slot / "meta.json").read_text())
        assert meta["trainer"] == "v2" and meta["epoch"] == 0 and meta["best_val_auc"] == -1.0
        assert meta["cfg"]["epochs"] == 0 and meta["model"]["gnn"]["out_dim"] == 128
        assert meta["imported_from"] == str(migrated["best_pt"].resolve())


def test_imported_slot_serves_as_the_jax_predictor(migrated, v2_ckpt):
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor

    records = load_records(FIXTURE / "data_complete.json")
    ref = JaxPredictor(v2_ckpt, batch_size=32).predict(records)
    pred = Predictor(out_dir=str(migrated["out"]), batch_size=32, device="cpu")
    try:
        got = pred.predict(records)
    finally:
        pred.close()
    assert [r["id"] for r in got] == [r["id"] for r in ref]
    np.testing.assert_allclose([r["prob_fake"] for r in got], [r["prob_fake"] for r in ref],
                               atol=ATOL, rtol=0)


def test_export_reproduces_the_file_it_came_from(migrated, v2_ckpt):
    from ultrafnd_git_tpu.training.checkpoint import load_checkpoint_raw
    from ultrafnd_git_tpu.utils.torch_transfer import v2_params_from_best_pt

    want = torch.load(migrated["best_pt"], weights_only=True)
    got = torch.load(migrated["back"], weights_only=True)
    for part in ("fusion", "clf", "gnn"):
        assert set(got[part]) == set(want[part]), part  # a strict load takes any order
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype and got[part][k].shape == v.shape, k
            assert torch.equal(got[part][k], v), k
    assert set(got["cfg"]) == set(migrated["jax_payload"]["cfg"])
    assert got["cfg"]["export_tool"] == export_reference.EXPORT_TOOL
    assert got["cfg"]["exported_slot"] == "best"

    params = load_checkpoint_raw(v2_ckpt, "best")[0]["params"]
    back = v2_params_from_best_pt(got)
    flat = {}

    def walk(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            flat[path] = np.array_equal(np.asarray(a), np.asarray(b))

    walk(back, {k: params[k] for k in ("fusion", "clf", "gnn")}, "")
    assert flat and all(flat.values()), [k for k, ok in flat.items() if not ok]


def _non_v2_slot(m, tmp):
    shutil.copytree(m["out"] / "best", tmp / "best")
    meta = json.loads((tmp / "best" / "meta.json").read_text())
    (tmp / "best" / "meta.json").write_text(json.dumps({**meta, "trainer": "integrated"}))
    return export_reference.main, ["--out_dir", str(tmp)], "trainer 'integrated'"


def _jax_slot(m, tmp, v2_ckpt):
    return (export_reference.main, ["--out_dir", v2_ckpt, "--dest", str(tmp / "x.pt")],
            "export_torch_model.py")


def _no_clf(m, tmp):
    path = tmp / "best.pt"
    torch.save({"fusion": torch.load(m["best_pt"], weights_only=True)["fusion"]}, path)
    return (import_reference.main, [str(path), "--data_root", str(FIXTURE), "--out_dir",
                                    str(tmp / "o"), "--cpu"], "has no 'clf' state dict")


def _gnn_dim(m, tmp):
    payload = torch.load(m["best_pt"], weights_only=True)
    payload["cfg"]["gnn_dim"] = 64  # the tensors are 128 wide
    torch.save(payload, tmp / "best.pt")
    return (import_reference.main,
            [str(tmp / "best.pt"), "--data_root", str(FIXTURE), "--out_dir", str(tmp / "o"),
             "--model_dir", str(m["model_dir"]), "--cpu"], "different gnn_dim/use_gnn")


@pytest.mark.parametrize("case", ["non_v2_slot", "jax_slot", "no_clf", "gnn_dim"])
def test_refusals_exit_2(migrated, v2_ckpt, tmp_path, case):
    made = {"non_v2_slot": lambda: _non_v2_slot(migrated, tmp_path),
            "jax_slot": lambda: _jax_slot(migrated, tmp_path, v2_ckpt),
            "no_clf": lambda: _no_clf(migrated, tmp_path),
            "gnn_dim": lambda: _gnn_dim(migrated, tmp_path)}[case]
    fn, argv, message = made()
    rc, said = _said(fn, argv)
    assert rc == 2 and message in said, said[-2000:]
    assert not (tmp_path / "o" / "best" / "meta.json").exists()


def test_import_runs_on_cuda_unless_asked_for_the_cpu(migrated, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu' explicitly"):
        import_reference.main([str(migrated["best_pt"]), "--data_root", str(FIXTURE),
                               "--out_dir", str(tmp_path / "o"),
                               "--model_dir", str(migrated["model_dir"])])
    assert import_reference.parse_args(["x.pt", "--data_root", "r", "--out_dir", "o"]).device \
        == "cuda"


def test_resume_fine_tunes_the_imported_slot_from_epoch_1(migrated, tmp_path, monkeypatch):
    from ultrafnd_git_tpu_torch import train
    from ultrafnd_git_tpu_torch.kernels import adamw

    out = tmp_path / "run"
    shutil.copytree(migrated["out"], out)
    calls = []
    plain = adamw.fused_adamw_

    def counted(leaves, scal):
        calls.append(scal.device.type)
        return plain(leaves, scal)

    monkeypatch.setattr(adamw, "fused_adamw_", counted)
    results, said = _said(train.main, [
        "--data_root", str(FIXTURE), "--model_dir", str(migrated["model_dir"]),
        "--out_dir", str(out), "--resume", "--epochs", "1", "--batch_size", "8",
        "--seed", "0", "--cpu"])
    assert "[Epoch 01]" in said and "starting fresh" not in said, said[-2000:]
    assert "feature cache: reusing" in said
    meta = json.loads((out / "latest" / "meta.json").read_text())
    with np.load(out / "feature_cache.npz") as z:
        steps = -(-len(z["split_train"]) // 8)
    assert meta["epoch"] == 1
    # K1's plain version: the GCN warm start's two updates, then one a step
    assert calls == ["cpu"] * (2 + steps)
    assert np.isfinite(results["test_loss"])


FAKE_FUSION = """
from torch import nn
from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer as _Port


class _Semantic(nn.Module):
    def __init__(self):
        super().__init__()
        self.text_proj = nn.Sequential(nn.Linear(512, 512))
        self.vision_proj = nn.Sequential(nn.Linear(512, 512))


class CrossModalTransformer(_Port):
    def __init__(self):
        super().__init__()
        self.semantic = _Semantic()
"""
FAKE_CLASSIFIER = """
from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier as _Port
from ultrafnd_git_tpu_torch.utils.config import classifier_config


class DeepTruthClassifier(_Port):
    def __init__(self):
        super().__init__(in_dim=512, **classifier_config("configs/model_configs/classifier.yaml"))
"""


def test_verify_plumbing_on_a_stand_in_reference_tree(migrated, tmp_path):
    """--verify's plumbing (the tree on sys.path, the strict loads, the
    logit comparison, the skip without a tree) on a stand-in tree whose
    modules have the reference's state-dict layout: the port's own classes
    plus the fusion's semantic projections. A plumbing check, not parity
    with the reference's modules, which this repo does not hold."""
    pkg = tmp_path / "src" / "models" / "fusion"
    pkg.mkdir(parents=True)
    for d in (tmp_path / "src", tmp_path / "src" / "models", pkg):
        (d / "__init__.py").write_text("")
    (pkg / "cross_modal_transformer.py").write_text(FAKE_FUSION)
    (pkg / "deep_truth_classifier.py").write_text(FAKE_CLASSIFIER)
    argv = ["--out_dir", str(migrated["out"]), "--dest", str(tmp_path / "v" / "best.pt"),
            "--verify"]
    try:
        rc, said = _said(export_reference.main, argv + ["--reference_tree", str(tmp_path)])
    finally:
        for name in [m for m in sys.modules if m == "src" or m.startswith("src.")]:
            del sys.modules[name]
    assert rc == 0 and "verify: max |logit delta| vs reference modules" in said, said
    rc, said = _said(export_reference.main, argv + ["--reference_tree", str(tmp_path / "none")])
    assert rc == 0 and "--verify skipped: reference tree not mounted" in said
