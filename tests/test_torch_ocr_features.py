"""PyTorch port, the OCR phrase-feature builder (`data/ocr.build_phrase_features`,
`save_phrase_features` and `python -m ultrafnd_git_tpu_torch.generate_ocr_phrase_features`)
against the JAX package's, on tests/fixtures/fakesv_tiny/data_complete.json.

The port's CLI (on the JSON array and on JSONL), JAX's functions and
JAX's script each write the two artifacts into a directory of their own: the mask files are equal byte for
byte and the unpickled dicts equal. The port's training CLI, given the
pickle with --ocr_phrase_pkl, builds a cache whose OCR sets are JAX's
`ocr_sets_for_records` on JAX's pickle.
"""
import hashlib
import io
import json
import pickle
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch import generate_ocr_phrase_features
from ultrafnd_git_tpu_torch.data import ocr as port_ocr
from ultrafnd_git_tpu_torch.predict import load_records

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny"
DATA = FIXTURE / "data_complete.json"
PKL = Path("fakesv") / "preprocess_ocr" / "ocr_phrase_fea.pkl"
SAM = Path("preprocess_ocr") / "sam"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs small tensors, which one thread computes faster
    than a pool that parallel test workers oversubscribe; the previous
    count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{writer: out_root} for the port's CLI (on the JSON array, and on the
    same records as JSONL), JAX's functions and JAX's script."""
    from ultrafnd_git_tpu.data import ocr as jax_ocr

    roots = {k: tmp_path_factory.mktemp(f"ocr_{k}")
             for k in ("port", "port_jsonl", "jax", "jax_script")}
    jsonl = roots["port_jsonl"] / "data_complete.jsonl"
    jsonl.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                             for r in load_records(DATA)), encoding="utf-8")
    with redirect_stdout(io.StringIO()):
        for name, data in (("port", DATA), ("port_jsonl", jsonl)):
            generate_ocr_phrase_features.main(["--data_path", str(data),
                                               "--out_root", str(roots[name])])
    features = jax_ocr.build_phrase_features(load_records(DATA))
    (roots["jax"] / SAM).mkdir(parents=True)
    for vid, toks in features["phrase_sets"].items():
        digest = hashlib.md5(" ".join(sorted(toks)).encode("utf-8")).hexdigest()
        (roots["jax"] / SAM / f"{vid}.mask.txt").write_text(digest, encoding="utf-8")
    jax_ocr.save_phrase_features(features, str(roots["jax"] / PKL))
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "generate_ocr_phrase_features.py"),
                           "--data_path", str(DATA), "--out_root", str(roots["jax_script"])],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return roots


@pytest.mark.parametrize("other", ["jax", "jax_script", "port_jsonl"])
def test_mask_files_equal_jax_byte_for_byte(artifacts, other):
    port = sorted(p.name for p in (artifacts["port"] / SAM).iterdir())
    assert port == sorted(p.name for p in (artifacts[other] / SAM).iterdir())
    assert len(port) == len(load_records(DATA))
    for name in port:
        assert (artifacts["port"] / SAM / name).read_bytes() == \
            (artifacts[other] / SAM / name).read_bytes(), name


@pytest.mark.parametrize("other", ["jax", "jax_script", "port_jsonl"])
def test_pickle_equals_jax(artifacts, other):
    with open(artifacts["port"] / PKL, "rb") as fh:
        port = pickle.load(fh)
    with open(artifacts[other] / PKL, "rb") as fh:
        ref = pickle.load(fh)
    assert port == ref
    assert any(port["phrase_sets"].values())  # the fixture's OCR has tokens


def test_builder_functions_equal_jax():
    from ultrafnd_git_tpu.data import ocr as jax_ocr

    records = load_records(DATA) + [{"ocr": "无 编号 记录 记录"}, {"id": "x1", "ocr": None}]
    assert port_ocr.build_phrase_features(records) == jax_ocr.build_phrase_features(records)


def test_train_cli_builds_jax_ocr_sets_from_the_pickle(artifacts, tmp_path):
    from ultrafnd_git_tpu.data.ocr import ocr_sets_for_records
    from ultrafnd_git_tpu_torch import train
    from ultrafnd_git_tpu_torch.data.cache import load_cache

    out = tmp_path / "run"
    with redirect_stdout(io.StringIO()) as said:
        train.main(["--data_root", str(FIXTURE), "--out_dir", str(out), "--epochs", "0",
                    "--batch_size", "8", "--ocr_phrase_pkl", str(artifacts["port"] / PKL),
                    "--cpu"])
    assert "feature cache: built" in said.getvalue()
    cache = load_cache(str(out / "feature_cache.npz"))
    want = ocr_sets_for_records(load_records(DATA), str(artifacts["jax"] / PKL))
    assert [sorted(s) for s in cache["ocr_sets"]] == [sorted(s) for s in want]
    with np.load(out / "feature_cache.npz") as z:  # built from the pickle
        assert json.loads(str(z["fingerprint"]))["ocr_phrase_pkl"] == \
            str((artifacts["port"] / PKL).resolve())
