"""PyTorch port: `build_feature_cache`, its fingerprint and the
trainer's cache ladder against the JAX package (`data/cache.py`), with
ULTRAFND_DISABLE_HF=1 (the hash rungs).

With the JAX align MLP's params carried into the port's
(`utils/transfer.align_state_dict`), `build_feature_cache` on the 640
records of `fakesv_hard` equals the JAX build: every host key exactly, the
align-derived `temporal`, `aux` and `evidence` within 1e-5. Without them the
port draws its own align MLP, which its fingerprint names, so neither
package takes the other's build for its own.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import jax
import numpy as np
import pytest

from ultrafnd_git_tpu.data import cache as jax_cache
from ultrafnd_git_tpu.data.dataset import FakeSVRawDataset as JaxRaw
from ultrafnd_git_tpu.ops import hashing as jax_hashing
from ultrafnd_git_tpu_torch.data import cache as port_cache
from ultrafnd_git_tpu_torch.data.dataset import FakeSVRawDataset
from ultrafnd_git_tpu_torch.models.temporal import TemporalSyncNet
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.utils.transfer import align_state_dict

REPO = Path(__file__).resolve().parents[1]
HARD = str(REPO / "tests" / "fixtures" / "fakesv_hard")
TINY = str(REPO / "tests" / "fixtures" / "fakesv_tiny")
HOST_KEYS = ("labels", "text", "audio", "visual", "text_ids", "text_mask", "emo", "evidence_host")
ALIGN_KEYS = ("temporal", "aux", "evidence")
ALIGN_ATOL = 1e-5
SEED = 7


@contextmanager
def salted(salt):
    """The same featurization salt in both packages (each keeps its own)."""
    prev = jax_hashing.get_hash_salt(), port_hashing.get_hash_salt()
    jax_hashing.set_hash_salt(salt)
    port_hashing.set_hash_salt(salt)
    try:
        yield
    finally:
        jax_hashing.set_hash_salt(prev[0])
        port_hashing.set_hash_salt(prev[1])


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Delete the test's run directories when it ends: one checkpoint's state.pt is
    ~150 MB, and what the tests leave behind would otherwise fill the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def encoders():
    """(JAX encoders, the port's with the JAX align params)."""
    jenc = jax_cache.make_encoders(seed=SEED)
    penc = port_cache.make_encoders(seed=SEED, device="cpu")
    penc["tsync"] = TemporalSyncNet(
        state_dict=align_state_dict(jax.device_get(jenc["tsync"].params)), device="cpu")
    return jenc, penc


@pytest.fixture(scope="module")
def phrase_pkl(tmp_path_factory):
    """An OCR phrase pickle covering every other fakesv_hard record."""
    raw = JaxRaw(HARD)
    sets = {}
    for i in range(0, len(raw), 2):
        rec = raw.get_item(i)
        sets[rec["id"]] = {t for t in (rec["title"] + " " + rec["ocr"]).split() if len(t) >= 2}
    path = tmp_path_factory.mktemp("pkl") / "ocr_phrase_fea.pkl"
    with open(path, "wb") as fh:
        pickle.dump({"phrase_sets": sets, "freqs": {}}, fh)
    return str(path)


def _assert_builds_match(ours, ref):
    assert set(ours) == set(ref)
    assert list(ours["ids"]) == list(ref["ids"])
    assert ours["ocr_sets"] == ref["ocr_sets"]
    for a, b in zip(ours["split"], ref["split"]):
        np.testing.assert_array_equal(a, b)
    for key in HOST_KEYS:
        if key in ref:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
            assert ours[key].dtype == ref[key].dtype, key
    for key in ALIGN_KEYS:
        if key in ref:
            np.testing.assert_allclose(ours[key], ref[key], atol=ALIGN_ATOL, rtol=0, err_msg=key)
            assert ours[key].dtype == ref[key].dtype and ours[key].shape == ref[key].shape


@pytest.mark.parametrize("with_evidence", [True, False], ids=["evidence", "no_evidence"])
@pytest.mark.parametrize("with_align", [True, False], ids=["align", "host_only"])
def test_build_matches_jax(encoders, with_align, with_evidence):
    jenc, penc = encoders
    kw = dict(seed=SEED, with_align=with_align, with_evidence=with_evidence)
    ref = jax_cache.build_feature_cache(JaxRaw(HARD), encoders=jenc, **kw)
    ours = port_cache.build_feature_cache(FakeSVRawDataset(HARD), encoders=penc, **kw)
    _assert_builds_match(ours, ref)
    if with_align and with_evidence:
        assert all(ours["evidence"][:, j].std() > 0 for j in range(3))
        np.testing.assert_array_equal(ours["evidence"][:, 2], ours["aux"][:, 0])


def test_build_with_a_phrase_pickle_and_a_salt_matches_jax(encoders, phrase_pkl):
    jenc, penc = encoders
    with salted("s1"):
        ref = jax_cache.build_feature_cache(JaxRaw(HARD), ocr_phrase_pkl=phrase_pkl, seed=SEED,
                                            encoders=jenc, with_tower_tokens=True)
        ours = port_cache.build_feature_cache(FakeSVRawDataset(HARD), ocr_phrase_pkl=phrase_pkl,
                                              seed=SEED, encoders=penc, with_tower_tokens=True)
    with salted(""):
        unsalted_text = port_cache.build_feature_cache(
            FakeSVRawDataset(HARD), seed=SEED, encoders=penc, with_evidence=False)["text"]
    _assert_builds_match(ours, ref)
    assert not np.array_equal(ours["text"], unsalted_text)  # the salt re-draws the hashes


def test_build_timings_split_host_and_align(encoders):
    seconds = {}
    port_cache.build_feature_cache(FakeSVRawDataset(TINY), seed=0, encoders=encoders[1],
                                   timings=seconds)
    assert set(seconds) == {"host_s", "align_s"} and min(seconds.values()) > 0


@pytest.mark.parametrize("salt", ["", "s1"], ids=["unsalted", "salted"])
@pytest.mark.parametrize("pkl", [None, "phrases.pkl"], ids=["no_pkl", "pkl"])
def test_fingerprint_is_the_jax_one_plus_the_align_draw(salt, pkl):
    with salted(salt):
        ours = json.loads(port_cache.cache_fingerprint(HARD, 3, pkl))
        ref = json.loads(jax_cache.cache_fingerprint(HARD, 3, pkl))
    assert ours.pop("align_init") == "torch"
    assert ours == ref
    assert ("hash_salt" in ref) is bool(salt)


def _port_run(tmp_path, name="run", **kw):
    kw = {"data_root": TINY, "seed": 0, "device": "cpu", **kw}
    return port_cache.bootstrap_cache(str(tmp_path / name), **kw)


def _stored_fingerprint(out_dir):
    with np.load(Path(out_dir) / "feature_cache.npz", allow_pickle=False) as z:
        return str(z["fingerprint"])


def test_jax_rebuilds_a_port_built_cache(tmp_path):
    cache, source = _port_run(tmp_path)
    assert source == "data_root" and (tmp_path / "run" / "align.pt").exists()
    path = str(tmp_path / "run" / "feature_cache.npz")
    assert jax_cache.load_cache(path, expected_fingerprint=jax_cache.cache_fingerprint(
        TINY, 0, None)) is None
    again = port_cache.load_cache(path, expected_fingerprint=port_cache.cache_fingerprint(
        TINY, 0, None))
    np.testing.assert_array_equal(again["temporal"], cache["temporal"])
    assert again["ocr_sets"] == cache["ocr_sets"]


def test_port_rebuilds_a_jax_built_out_dir_cache(tmp_path, capsys):
    run = tmp_path / "run"
    jax_cache.bootstrap_cache(TINY, str(run), seed=0)
    assert json.loads(_stored_fingerprint(run)) == json.loads(
        jax_cache.cache_fingerprint(TINY, 0, None))
    capsys.readouterr()
    cache, source = _port_run(tmp_path)
    assert source == "data_root" and "different config" in capsys.readouterr().out
    assert _stored_fingerprint(run) == port_cache.cache_fingerprint(TINY, 0, None)
    assert port_cache.load_align(str(run))["state_dict"].keys() == {
        "proj_in.weight", "proj_in.bias", "proj_out.weight", "proj_out.bias"}


def test_injected_cache_is_stamped_and_not_reused_as_a_build(tmp_path):
    built, _ = _port_run(tmp_path, "src")
    cache, source = _port_run(tmp_path, cache=built)
    assert source == "injected" and cache is built
    assert _stored_fingerprint(tmp_path / "run") == "injected"
    assert not (tmp_path / "run" / "align.pt").exists()  # the injector's align is unknown
    for pkg in (port_cache, jax_cache):  # both packages rebuild an injected cache
        assert pkg.load_cache(str(tmp_path / "run" / "feature_cache.npz"),
                              expected_fingerprint=pkg.cache_fingerprint(TINY, 0, None)) is None
    _, source = _port_run(tmp_path)
    assert source == "data_root"


def test_out_dir_cache_is_reused_on_a_matching_fingerprint(tmp_path, capsys):
    first, source = _port_run(tmp_path)
    path = tmp_path / "run" / "feature_cache.npz"
    stamp = path.stat().st_mtime_ns, (tmp_path / "run" / "align.pt").stat().st_mtime_ns
    capsys.readouterr()
    again, source2 = _port_run(tmp_path)
    assert (source, source2) == ("data_root", "out_dir")
    assert "feature cache: reusing" in capsys.readouterr().out
    assert (path.stat().st_mtime_ns, (tmp_path / "run" / "align.pt").stat().st_mtime_ns) == stamp
    for key in ("text", "temporal", "aux", "evidence", "text_ids"):
        np.testing.assert_array_equal(again[key], first[key], err_msg=key)


@pytest.mark.parametrize("change", ["data_root", "seed", "ocr_phrase_pkl", "hash_salt"])
def test_a_changed_config_rebuilds(tmp_path, change, phrase_pkl):
    _port_run(tmp_path)
    kw = {}
    if change == "data_root":
        kw["data_root"] = shutil.copytree(TINY, tmp_path / "moved")
    elif change == "seed":
        kw["seed"] = 1
    elif change == "ocr_phrase_pkl":
        kw["ocr_phrase_pkl"] = phrase_pkl
    with salted("s1" if change == "hash_salt" else ""):
        _, source = _port_run(tmp_path, **kw)
        expected = port_cache.cache_fingerprint(
            str(kw.get("data_root", TINY)), kw.get("seed", 0), kw.get("ocr_phrase_pkl"))
    assert source == "data_root"
    assert _stored_fingerprint(tmp_path / "run") == expected


def _make_stale(path: Path) -> None:
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["features_version"] = np.int64(2)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


@pytest.mark.parametrize("mode", ["fresh", "eval_only", "resume"])
def test_stale_features_rebuild_when_fresh_and_are_reused_by_a_checkpoint(tmp_path, mode):
    _port_run(tmp_path)
    path = tmp_path / "run" / "feature_cache.npz"
    _make_stale(path)
    _, source = _port_run(tmp_path, reuse_stale_features=mode != "fresh")
    assert source == ("data_root" if mode == "fresh" else "out_dir")
    with np.load(path, allow_pickle=False) as z:
        assert int(z["features_version"]) == (3 if mode == "fresh" else 2)


def _seeded_model_dir(root, cache):
    from ultrafnd_git_tpu_torch.serving import write_seeded_model_dir

    meta = {
        "cfg": {"use_gnn": False, "seed": 0},
        "fusion": {"hidden": 16, "use_gnn": False, "gnn_dim": 8, "text_dim": 768,
                   "audio_dim": 128, "visual_dim": 512, "temporal_dim": 256},
        "classifier": {"hidden": 8, "num_classes": 2, "use_aux": True, "aux_dim": 2,
                       "node_trees": 2, "node_depth": 2, "node_tau": 10.0,
                       "temperature_init": 1.0},
        "gnn": None,
        "align": {"in_dim": 768, "out_dim": 256},
        "text_tower": None,
    }
    return write_seeded_model_dir(str(root), meta, cache)


def test_model_dir_cache_is_copied_with_its_align_and_a_stale_one_falls_to_data_root(tmp_path):
    import torch

    built, _ = _port_run(tmp_path, "src")
    model = _seeded_model_dir(tmp_path / "model", built)
    _, source = port_cache.bootstrap_cache(str(tmp_path / "run"), str(model), device="cpu")
    assert source == "model_dir"
    assert (tmp_path / "run" / "feature_cache.npz").read_bytes() == \
        (model / "feature_cache.npz").read_bytes()
    align = port_cache.load_align(str(tmp_path / "run"))
    ref = torch.load(model / "weights.pt", weights_only=True)["align"]
    assert (align["in_dim"], align["out_dim"]) == (768, 256)
    assert all(torch.equal(align["state_dict"][k], v) for k, v in ref.items())

    _make_stale(model / "feature_cache.npz")
    with pytest.raises(FileNotFoundError, match="no data_root"):
        port_cache.bootstrap_cache(str(tmp_path / "fresh"), str(model), device="cpu")
    _, source = port_cache.bootstrap_cache(str(tmp_path / "fresh"), str(model),
                                           data_root=TINY, seed=0, device="cpu")
    assert source == "data_root"


def test_missing_data_root_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="data_complete.json not found"):
        _port_run(tmp_path, data_root=str(tmp_path / "nowhere"))


def test_train_cli_from_a_raw_data_root_exports_and_serves_without_jax(tmp_path):
    """train --data_root --use_evidence --train_text_tower --device cpu
    --export_model_dir E, then predict on E, in one fresh process that loads
    no module of jax or of the JAX package; the served forensic scalars of
    the corpus records are their cached evidence."""
    out, exported, preds = tmp_path / "O", tmp_path / "E", tmp_path / "preds.jsonl"
    code = (
        "import sys\n"
        "from ultrafnd_git_tpu_torch.train import main\n"
        "from ultrafnd_git_tpu_torch.predict import main as predict\n"
        f"main(['--data_root', {TINY!r}, '--out_dir', {str(out)!r}, '--use_evidence',"
        " '--train_text_tower', '--text_tower_depth', '1', '--text_tower_heads', '4',"
        " '--epochs', '1', '--batch_size', '16', '--device', 'cpu',"
        f" '--export_model_dir', {str(exported)!r}])\n"
        f"predict(['--model_dir', {str(exported)!r}, '--input',"
        f" {TINY + '/data_complete.json'!r}, '--device', 'cpu', '--output', {str(preds)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ultrafnd_git_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), ULTRAFND_DISABLE_HF="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout and "feature cache: built from" in proc.stdout
    fp = json.loads(_stored_fingerprint(out))
    assert fp == {"data_root": TINY, "seed": 42, "ocr_phrase_pkl": None, "align_init": "torch"}
    assert json.loads((exported / "meta.json").read_text())["cfg"]["use_evidence"] is True
    rows = [json.loads(ln) for ln in preds.read_text().splitlines()]
    cache = port_cache.load_cache(str(out / "feature_cache.npz"))
    assert [r["id"] for r in rows] == list(cache["ids"])
    p = np.array([r["prob_fake"] for r in rows])
    assert np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()
    ev = cache["evidence"]
    np.testing.assert_array_equal([r["semantic_conflict"] for r in rows], ev[:, 0])
    np.testing.assert_array_equal([r["emotion_intensity"] for r in rows], ev[:, 1])
    np.testing.assert_allclose([r["temporal_delay"] for r in rows], ev[:, 2], atol=1e-5)
