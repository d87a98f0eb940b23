"""PyTorch port: its own copies of the host ops equal the JAX package's.

The port keeps copies of the jax-free host code it calls (FNV hashing and
the process-wide salt, hash embeddings, OCR token sets, the Jaccard
adjacency, the C++ host ops and the reference state-dict layout). On the
same seeded inputs each copy gives exactly what the JAX original gives, on
the native (C++) path and on the numpy path. A fresh process that imports
every module of the port loads no module of the JAX package.
"""
import importlib
import os
import pickle
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ultrafnd_git_tpu_torch
from ultrafnd_git_tpu import native as jax_native
from ultrafnd_git_tpu.data import ocr as jax_ocr
from ultrafnd_git_tpu.ops import hashing as jax_hashing
from ultrafnd_git_tpu.utils import torch_transfer as jax_transfer
from ultrafnd_git_tpu_torch import native
from ultrafnd_git_tpu_torch.data import ocr
from ultrafnd_git_tpu_torch.ops import hashing, jaccard
from ultrafnd_git_tpu_torch.utils import transfer

REPO = Path(__file__).resolve().parents[1]
# `ultrafnd_git_tpu.ops` re-exports a function named `jaccard`
jax_jaccard = importlib.import_module("ultrafnd_git_tpu.ops.jaccard")
WORDS = ["外星人", "入侵", "地球", "警告", "辟谣", "a", "bc", "hello", "world", "2024",
         "abc中文def", "x　y", "tab\tsep", "é", "nbsp x"]


def _texts(seed, n=40):
    rng = np.random.default_rng(seed)
    out = [" ".join(rng.choice(WORDS, size=int(rng.integers(0, 12)))) for _ in range(n)]
    return out + ["", "   ", "\n", "单"]


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Both packages on the native path, or both on the numpy path."""
    if request.param == "numpy":
        monkeypatch.setenv("ULTRAFND_NATIVE", "0")
    native.reset()
    jax_native.reset()
    if request.param == "native":
        assert native.get_lib("hashops") is not None and native.get_lib("graphops") is not None
    yield request.param
    native.reset()
    jax_native.reset()


@pytest.fixture(params=["", "salted"])
def salt(request):
    prev = (hashing.get_hash_salt(), jax_hashing.get_hash_salt())
    hashing.set_hash_salt(request.param)
    jax_hashing.set_hash_salt(request.param)
    yield request.param
    hashing.set_hash_salt(prev[0])
    jax_hashing.set_hash_salt(prev[1])


def test_fnv_hashes_match(salt, path):
    assert hashing.get_hash_basis() == jax_hashing.get_hash_basis()
    for tok in {w for t in _texts(0) for w in t.split()} | {"", "外星人"}:
        h = hashing.fnv1a_64(tok)
        assert h == jax_hashing.fnv1a_64(tok)
        pinned = hashing.basis_for_salt("pinned")
        assert pinned == jax_hashing.basis_for_salt("pinned")
        assert hashing.fnv1a_64(tok, pinned) == jax_hashing.fnv1a_64(tok, pinned)
        got = native.fnv1a_64_native(tok)
        assert got == jax_native.fnv1a_64_native(tok)
        assert got is None if path == "numpy" else got == h


@pytest.mark.parametrize("dim,max_tokens", [(768, None), (128, 128), (256, 3)])
def test_hash_embed_batch_matches(salt, path, dim, max_tokens):
    texts = _texts(1)
    ours = hashing.hash_embed_batch(texts, dim, max_tokens=max_tokens)
    ref = jax_hashing.hash_embed_batch(texts, dim, max_tokens=max_tokens)
    assert ours.dtype == np.float32 and ours.shape == (len(texts), dim)
    np.testing.assert_array_equal(ours, ref)


def test_hash_embed_native_equals_numpy(salt, monkeypatch):
    native.reset()
    texts = _texts(2)
    fast = hashing.hash_embed_batch(texts, 512, max_tokens=5)
    monkeypatch.setenv("ULTRAFND_NATIVE", "0")
    slow = hashing.hash_embed_batch(texts, 512, max_tokens=5)
    # C++ multiplies by a float64 reciprocal of the norm, numpy divides in f32
    np.testing.assert_array_max_ulp(fast, slow, maxulp=1)


def test_token_vocabulary_matches():
    sets = [set(t.split()) for t in _texts(3)]
    assert hashing.token_vocabulary(sets) == jax_hashing.token_vocabulary(sets)


@pytest.mark.parametrize("thresh", [0.12, 0.3, 0.0])
def test_build_adj_from_ocr_matches(path, thresh):
    rng = np.random.default_rng(4)
    vocab = [f"t{i}" for i in range(30)]
    sets = [set(rng.choice(vocab, size=int(rng.integers(0, 8)), replace=False))
            for _ in range(60)]
    sets += [set(), set(), {"t1"}]  # empty OCR sets, and a lone token
    ours = jaccard.build_adj_from_ocr(sets, thresh=thresh)
    ref = jax_jaccard.build_adj_from_ocr(sets, thresh=thresh)
    assert ours.dtype == np.float32 and ours.shape == (len(sets), len(sets))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(jaccard.pairwise_jaccard(sets), jax_jaccard.pairwise_jaccard(sets))
    assert jaccard.build_adj_from_ocr([]).shape == (0, 0)


def test_ocr_sets_for_records_match(tmp_path):
    rng = np.random.default_rng(5)
    recs = [{"video_id": f"v{i}", "ocr": " ".join(rng.choice(WORDS, size=6)) + " 外星人入侵，地球!"}
            for i in range(12)]
    recs += [{"id": "x"}, {"ocr": None}, {"video_id": "v3", "ocr": "a\tbc\nde"}]
    pkl = tmp_path / "phrases.pkl"
    with open(pkl, "wb") as fh:
        pickle.dump({"phrase_sets": {"v1": {"外星人", "警告"}, "v4": set()}, "freqs": {}}, fh)
    for kwargs in ({}, {"clean_fallback": True}, {"ocr_phrase_pkl": str(pkl)},
                   {"ocr_phrase_pkl": str(pkl), "clean_fallback": False},
                   {"ocr_phrase_pkl": str(tmp_path / "missing.pkl")}):
        assert ocr.ocr_sets_for_records(recs, **kwargs) == jax_ocr.ocr_sets_for_records(recs, **kwargs)


def _dense(rng, i, o):
    return {"kernel": rng.standard_normal((i, o)).astype(np.float32),
            "bias": rng.standard_normal(o).astype(np.float32)}


def _coattn(rng, h):
    return {k: _dense(rng, h, h) for k in ("q", "k", "v", "evidence_in", "evidence_out")}


@pytest.mark.parametrize("with_gnn", [True, False])
def test_state_dict_functions_match(with_gnn):
    rng = np.random.default_rng(6)
    h = 8
    fusion = {**{n: _dense(rng, 5, h) for n in ("text_proj", "audio_proj", "visual_proj",
                                                  "temporal_proj")},
              **{n: _coattn(rng, h) for n in ("attn_tv", "attn_ta", "attn_vu")},
              "fuse0": _dense(rng, 3 * h, h), "fuse1": _dense(rng, h, h),
              "head": _dense(rng, h, 2)}
    if with_gnn:
        fusion["gnn_proj"] = _dense(rng, 4, h)
    clf = {"pre0": _dense(rng, 6, h), "pre1": _dense(rng, h, h), "bypass": _dense(rng, h, 2),
           "temperature": np.float32(1.5),
           "node": {"gates": rng.standard_normal((3, 2, h)).astype(np.float32),
                    "thresh": rng.standard_normal((3, 2)).astype(np.float32),
                    "leaf_logits": rng.standard_normal((3, 4, 2)).astype(np.float32)}}
    gcn = {"lin1": _dense(rng, 6, 4), "lin2": _dense(rng, 4, 3)}
    pairs = [
        (transfer.fusion_state_dict_from_params(fusion),
         jax_transfer.fusion_state_dict_from_params(fusion)),
        (transfer.classifier_state_dict_from_params(clf, tau=7.0),
         jax_transfer.classifier_state_dict_from_params(clf, tau=7.0)),
        (transfer.gcn_state_dict_from_params(gcn), jax_transfer.gcn_state_dict_from_params(gcn)),
    ]
    for ours, ref in pairs:
        assert list(ours) == list(ref)
        for key in ref:
            assert ours[key].dtype == ref[key].dtype, key
            assert ours[key].shape == ref[key].shape, key
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_port_modules_load_nothing_of_the_jax_package():
    """A fresh process imports every module of the port, then lists the
    modules of the JAX package (and of jax) that it loaded: none."""
    mods = sorted(m.name for m in pkgutil.walk_packages(
        ultrafnd_git_tpu_torch.__path__, "ultrafnd_git_tpu_torch."))
    assert "ultrafnd_git_tpu_torch.native" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ultrafnd_git_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
        "print('PORT_ALONE_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT_ALONE_OK" in proc.stdout
