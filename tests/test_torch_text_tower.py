"""PyTorch port, the text ladder's tower rung (`ULTRAFND_TEXT_DEVICE` and
`ULTRAFND_TEXT_DEVICE_CKPT`) against the JAX package's.

Counterparts of `tests/test_text_device_tower.py`'s seven tests, plus the
port's own: the seeded draw of each package differs, so the JAX tower's
params are injected into the port's encoder through
`utils/transfer.tower_state_dict`; the trained tower is the shared
`tower_ckpt` checkpoint, carried across by `scripts/export_torch_model.py`,
and a port out_dir trained from that export. Everything runs on the CPU,
where K2's wrapper runs its plain version and JAX's `flash_attention`
(backend "auto", S < 512) its XLA reference: both exact f32 attention.

Tolerances: encodings 1e-5; record fields and the cache's text column
1e-5; served prob_fake 1e-4.
"""
import importlib.util
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.models.text import BERTContextEncoder
from ultrafnd_git_tpu.models.transformer import DeviceTextEncoder as JaxTower
from ultrafnd_git_tpu_torch.data import cache as port_cache
from ultrafnd_git_tpu_torch.data.dataset import FakeSVRawDataset
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
from ultrafnd_git_tpu_torch.models.encoders import TextFieldEncoder, tower_rung
from ultrafnd_git_tpu_torch.models.transformer import DeviceTextEncoder, TextTransformer
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.training import trainer as port_trainer
from ultrafnd_git_tpu_torch.utils.transfer import tower_state_dict

REPO = Path(__file__).resolve().parents[1]
TINY = str(REPO / "tests" / "fixtures" / "fakesv_tiny")
SMALL = dict(dim=64, depth=2, heads=4, max_len=16)
ENC_TOL = dict(atol=1e-5, rtol=0)
TEXTS = ["外星人 入侵 地球", "", "证据 科学", "谣言 危险 视频 记录", "hello world", "专家 辟谣",
         "", "疫苗 致命 隐瞒", "警告", "a b c d e f g h i j k l m n o p q r"]
DEVICE, CKPT = "ULTRAFND_TEXT_DEVICE", "ULTRAFND_TEXT_DEVICE_CKPT"


@pytest.fixture(autouse=True)
def _rung_env(monkeypatch):
    """Each test starts on the hash rung with both packages unsalted."""
    monkeypatch.delenv(DEVICE, raising=False)
    monkeypatch.delenv(CKPT, raising=False)
    from ultrafnd_git_tpu.ops.hashing import set_hash_salt as jax_set_salt

    jax_set_salt("")
    port_hashing.set_hash_salt("")
    yield
    jax_set_salt("")
    port_hashing.set_hash_salt("")


def _port_of(jax_tower, **kw) -> DeviceTextEncoder:
    """A port encoder of the JAX tower's dims carrying its params."""
    m = jax_tower.module
    enc = DeviceTextEncoder(dim=m.width, depth=m.depth, heads=m.heads, max_len=m.max_len,
                            vocab_size=m.vocab_size, gelu=m.gelu, device="cpu",
                            init_params=False, **kw)
    enc.load_state_dict(tower_state_dict(jax.device_get(jax_tower.params)))
    return enc


@pytest.fixture(scope="module")
def jax_small():
    return JaxTower(**SMALL, seed=0)


@pytest.fixture(scope="module")
def exported(tower_ckpt, tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("tower_model")
    mod.export(tower_ckpt["out"], str(out))
    yield str(out)
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def port_run(exported, tmp_path_factory):
    """A port out_dir (best and latest slots) trained from the export."""
    out = tmp_path_factory.mktemp("port_tower_run")
    cfg = port_trainer.TrainConfig(out_dir=str(out), model_dir=exported, batch_size=8,
                                   epochs=1, seed=0, train_text_tower=True,
                                   text_tower_depth=1, text_tower_heads=4,
                                   log_metrics_jsonl=False)
    port_trainer.ForensicTrainer(cfg, device="cpu").fit()
    yield str(out)
    shutil.rmtree(out, ignore_errors=True)  # its slots are hundreds of MB


def _slot_tower(out_dir, slot):
    payload = torch.load(Path(out_dir) / slot / "state.pt", weights_only=True)
    return payload["params"]["text_tower"]


# ---- the JAX file's seven tests -------------------------------------------

def test_tower_rung_engages_when_enabled():
    """The rung engages, gives JAX's rows from JAX's draw (empty strings zero,
    the rest unit norm) and differs from the hash rung, which is JAX's too."""
    jenc = BERTContextEncoder(dim=64, max_length=16, use_device_tower=True)
    assert not jenc.use_hf
    ours = TextFieldEncoder(dim=64, max_length=16, use_device_tower=True, device="cpu")
    seeded = ours._tower()  # the port's own draw: JAX's dims, its distribution
    m = jenc._tower().module
    assert (seeded.dim, len(seeded.tower.blocks), seeded.max_len) == (64, m.depth, m.max_len)
    assert seeded.tower.blocks[0].attn.heads == m.heads == 1 and not seeded.trained
    ours._device_tower = _port_of(jenc._tower())
    out = ours.encode_batch(TEXTS)
    np.testing.assert_allclose(out, jenc.encode_batch(TEXTS), **ENC_TOL)
    empty = [i for i, t in enumerate(TEXTS) if not t]
    assert np.all(out[empty] == 0.0)
    full = [i for i, t in enumerate(TEXTS) if t]
    np.testing.assert_allclose(np.linalg.norm(out[full], axis=-1), 1.0, atol=1e-5)
    hashed = TextFieldEncoder(dim=64, max_length=16, use_device_tower=False, device="cpu")
    assert not np.allclose(out, hashed.encode_batch(TEXTS))
    ref_hash = BERTContextEncoder(dim=64, max_length=16, use_device_tower=False)
    np.testing.assert_array_equal(hashed.encode_batch(TEXTS), ref_hash.encode_batch(TEXTS))


@pytest.mark.parametrize("device_var,with_ckpt", [
    (None, False), ("0", False), ("1", False), (None, True), ("0", True), ("1", True),
])
def test_env_vars_select_as_jax_does(monkeypatch, tower_ckpt, exported, device_var,
                                     with_ckpt):
    """The two variables pick the same rung in both packages: the trained
    tower only under ULTRAFND_TEXT_DEVICE=1 with the CKPT variable, the
    seeded tower under ULTRAFND_TEXT_DEVICE=1 alone, the hash rung
    otherwise (the CKPT variable alone does nothing). Trained rows agree."""
    if device_var is not None:
        monkeypatch.setenv(DEVICE, device_var)
    if with_ckpt:
        monkeypatch.setenv(CKPT, tower_ckpt["out"])
    jenc = BERTContextEncoder()
    jax_tower = jenc._tower()  # JAX reads the CKPT variable at first use
    ref = jenc.encode_batch(TEXTS) if jax_tower is None or jax_tower.trained else None
    if with_ckpt:
        monkeypatch.setenv(CKPT, exported)  # the same tower, carried across
    ours = TextFieldEncoder(device="cpu")
    assert ours._want_device_tower == jenc._want_device_tower == (device_var == "1")
    rung, tower = tower_rung(), ours._tower()
    if device_var != "1":
        assert rung is None and tower is None and jax_tower is None
        np.testing.assert_array_equal(ours.encode_batch(TEXTS), ref)
    elif not with_ckpt:
        assert rung == "tower-seeded"
        assert not tower.trained and not jax_tower.trained
    else:
        assert rung == f"tower:{Path(exported).resolve()}"
        assert tower.trained and jax_tower.trained
        np.testing.assert_allclose(ours.encode_batch(TEXTS), ref, **ENC_TOL)


def test_single_and_batch_agree_across_chunks(jax_small):
    """One string, a whole batch and chunks of 3 strings (buckets padded
    with "") give the same rows, and JAX's at every chunk size."""
    ours = _port_of(jax_small)
    texts = [t for t in TEXTS if t] * 3  # 24 strings: 8 chunks of 3
    whole = ours.encode_batch(texts)
    np.testing.assert_allclose(ours.encode_batch(texts, batch_size=3), whole, atol=1e-6)
    np.testing.assert_allclose(whole, jax_small.encode_batch(texts), **ENC_TOL)
    np.testing.assert_allclose(whole, jax_small.encode_batch(texts, batch_size=3), **ENC_TOL)
    field = TextFieldEncoder(dim=64, max_length=16, use_device_tower=True, device="cpu")
    field._device_tower = ours
    np.testing.assert_allclose(field.encode(texts[1]), whole[1], atol=1e-6)
    assert np.all(field.encode("") == 0.0)
    assert ours.encode_batch([]).shape == (0, 64)


def test_from_checkpoint_serves_trained_tower(tower_ckpt, exported):
    """The export of tower_ckpt serves JAX's trained tower: dims, gelu and
    rows of JAX's from_checkpoint(out_dir); the salt is pinned on the
    encoder and the process-wide salt stays as it was."""
    port_hashing.set_hash_salt("process-salt")
    ours = DeviceTextEncoder.from_checkpoint(exported, device="cpu")
    assert port_hashing.get_hash_salt() == "process-salt"
    port_hashing.set_hash_salt("")
    ref = JaxTower.from_checkpoint(tower_ckpt["out"])
    assert ours.trained and ref.trained
    m = ref.module
    assert (ours.dim, ours.max_len, ours.vocab_size) == (768, ref.max_len, ref.vocab_size)
    assert len(ours.tower.blocks) == m.depth == 1
    assert ours.tower.blocks[0].attn.heads == m.heads == 4
    assert ours.tower.blocks[0].gelu == m.gelu == "tanh"
    assert ours.hash_salt == ref.hash_salt == ""
    texts = ["外星人 入侵 警告", "官方 辟谣 证据"] + [t for t in TEXTS if t]
    out = ours.encode_batch(texts)
    np.testing.assert_allclose(out, ref.encode_batch(texts), **ENC_TOL)
    seeded = DeviceTextEncoder(dim=768, depth=1, heads=4, max_len=ours.max_len, device="cpu")
    assert not np.allclose(out, seeded.encode_batch(texts), atol=1e-3)


def test_pinned_salt_tokenizes_as_the_process_salt_would(exported):
    ours = DeviceTextEncoder.from_checkpoint(exported, device="cpu")
    ours.hash_salt = "s1"
    pinned = ours.encode_batch(TEXTS[:4])
    ours.hash_salt = None
    port_hashing.set_hash_salt("s1")
    np.testing.assert_array_equal(ours.encode_batch(TEXTS[:4]), pinned)
    port_hashing.set_hash_salt("")
    assert not np.allclose(ours.encode_batch(TEXTS[:4]), pinned)


def test_remat_tower_is_exact(jax_small):
    """remat on and off: the same forward and gradients, bit for bit, with
    dropout on (the masks are drawn before each block)."""
    sd = tower_state_dict(jax.device_get(jax_small.params))
    kw = dict(width=64, depth=2, heads=4, max_len=16)
    plain, remat = TextTransformer(**kw), TextTransformer(**kw, remat=True)
    for mod in (plain, remat):
        mod.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    ids = torch.from_numpy(np.random.RandomState(0).randint(1, 1000, (4, 16))).long()
    mask = torch.ones(4, 16)
    outs, grads = [], []
    for mod in (plain, remat):
        out = mod(ids, mask, gen=torch.Generator().manual_seed(7))
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * out).sum(), list(mod.parameters())))
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_tower_gelu_variants(jax_small):
    """tanh and exact GELU share params and differ; each equals JAX's."""
    from ultrafnd_git_tpu.models.transformer import TextTransformer as JaxTT

    sd = tower_state_dict(jax.device_get(jax_small.params))
    ids = np.arange(32, dtype=np.int32).reshape(2, 16) % 63 + 1
    mask = np.ones((2, 16), np.float32)
    outs = {}
    for kind in ("tanh", "exact"):
        mod = TextTransformer(width=64, depth=2, heads=4, max_len=16, gelu=kind)
        mod.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        with torch.no_grad():
            outs[kind] = mod(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
        ref = JaxTT(width=64, depth=2, heads=4, vocab_size=32768, max_len=16,
                    gelu=kind).apply({"params": jax_small.params}, ids, mask, deterministic=True)
        np.testing.assert_allclose(outs[kind], np.asarray(ref), **ENC_TOL)
    assert not np.array_equal(outs["tanh"], outs["exact"])


def _link_copy(src, dst, skip=()):
    """`src` rebuilt under `dst` with its meta.json files copied and every
    other file a symlink (the tower's slots are hundreds of MB), leaving out
    the top-level entries named in `skip`."""
    for path in sorted(Path(src).rglob("*")):
        rel = path.relative_to(src)
        if rel.parts[0] in skip or path.is_dir():
            continue
        target = Path(dst) / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        if path.name == "meta.json":
            shutil.copyfile(path, target)
        else:
            target.symlink_to(path)
    return str(dst)


def _legacy_copy(src, dst, slot=None):
    """`src` with tower_gelu dropped from its meta (a checkpoint that
    predates the field)."""
    _link_copy(src, dst)
    meta_p = Path(dst) / (slot or "") / "meta.json"
    meta = json.loads(meta_p.read_text())
    meta["cfg"].pop("tower_gelu", None)
    dims = (meta.get("model") or meta).get("text_tower")
    dims.pop("gelu", None)
    meta_p.write_text(json.dumps(meta))
    return str(dst)


def test_tower_gelu_recorded_and_adopted(exported, port_run, tmp_path):
    """The recorded gelu is adopted; a meta that predates the field gives
    "exact", from a model directory, from a slot, and in the trainer's
    eval_only adoption (with the tower's depth and heads)."""
    assert DeviceTextEncoder.from_checkpoint(exported, device="cpu").tower.blocks[0].gelu == \
        "tanh"
    assert DeviceTextEncoder.from_checkpoint(port_run, device="cpu").tower.blocks[0].gelu == \
        "tanh"
    legacy_dir = _legacy_copy(exported, tmp_path / "legacy_model")
    assert DeviceTextEncoder.from_checkpoint(legacy_dir, device="cpu").tower.blocks[0].gelu \
        == "exact"
    legacy_run = _legacy_copy(port_run, tmp_path / "legacy_run", slot="best")
    assert DeviceTextEncoder.from_checkpoint(legacy_run, device="cpu").tower.blocks[0].gelu \
        == "exact"
    cfg = port_trainer.TrainConfig(out_dir=legacy_run, eval_only=True)
    port_trainer._adopt_checkpoint_fields(cfg)
    assert (cfg.tower_gelu, cfg.text_tower_depth, cfg.text_tower_heads) == ("exact", 1, 4)


# ---- the port's own --------------------------------------------------------

@pytest.mark.parametrize("case", ["best", "latest_only", "named_latest"])
def test_from_checkpoint_reads_a_port_out_dir(port_run, tmp_path, case):
    """A port out_dir's slot: best, then latest (a run without best), or the
    named one; its tower weights and the slot's dims."""
    src = port_run
    if case == "latest_only":
        src = str(tmp_path / "run")
        _link_copy(port_run, src, skip=("best",))
    name = "latest" if case == "named_latest" else None
    enc = DeviceTextEncoder.from_checkpoint(src, checkpoint_name=name, device="cpu")
    slot = "best" if case == "best" else "latest"
    want = _slot_tower(src, slot)
    got = enc.tower.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert (len(enc.tower.blocks), enc.tower.blocks[0].attn.heads) == (1, 4)


@pytest.mark.parametrize("case,error,words", [
    ("missing", FileNotFoundError, "no checkpoint slot"),
    ("no_tower", ValueError, "--train_text_tower"),
    ("jax_out_dir", ValueError, "scripts/export_torch_model.py"),
])
def test_from_checkpoint_refuses(port_run, tower_ckpt, tmp_path, case, error, words):
    """An out_dir without a slot, a run without a tower, and a JAX out_dir
    (Orbax state/, no state.pt: carried across by the export script)."""
    if case == "missing":
        path = str(tmp_path / "empty")
        Path(path).mkdir()
    elif case == "no_tower":
        path = str(tmp_path / "plain")
        _link_copy(port_run, path)
        for slot in ("best", "latest"):
            meta_p = Path(path) / slot / "meta.json"
            meta = json.loads(meta_p.read_text())
            meta["cfg"]["train_text_tower"] = False
            meta_p.write_text(json.dumps(meta))
    else:
        path = tower_ckpt["out"]
    with pytest.raises(error, match=words.replace(".", r"\.")):
        DeviceTextEncoder.from_checkpoint(path, device="cpu")


@pytest.fixture(scope="module")
def hash_cache():
    return port_cache.build_feature_cache(
        FakeSVRawDataset(TINY), seed=0, with_evidence=False,
        encoders=port_cache.make_encoders(seed=0, with_evidence=False, device="cpu"))


def test_cache_text_column_under_the_rung_is_jaxs(monkeypatch, hash_cache):
    """build_feature_cache on fakesv_tiny under ULTRAFND_TEXT_DEVICE=1 (64
    wide, the seeded ladder's 1 head of 64 x depth 4 at S = 256, JAX's draw
    injected) gives JAX's text column; every host key but text is the hash
    build's."""
    from ultrafnd_git_tpu.data import cache as jax_cache
    from ultrafnd_git_tpu.data.dataset import FakeSVRawDataset as JaxRaw

    monkeypatch.setenv(DEVICE, "1")
    jenc = jax_cache.make_encoders(text_dim=64, seed=0, with_evidence=False)
    penc = port_cache.make_encoders(text_dim=64, seed=0, with_evidence=False, device="cpu")
    penc["text"]._device_tower = _port_of(jenc["text"]._tower())
    assert penc["text"]._device_tower.tower.blocks[0].attn.heads == 1
    ref = jax_cache.build_feature_cache(JaxRaw(TINY), text_dim=64, seed=0, encoders=jenc,
                                       with_evidence=False, with_align=False)
    ours = port_cache.build_feature_cache(FakeSVRawDataset(TINY), text_dim=64, seed=0,
                                          encoders=penc, with_evidence=False, with_align=False)
    np.testing.assert_allclose(ours["text"], ref["text"], **ENC_TOL)
    assert not np.allclose(ours["text"][:, :64], hash_cache["text"][:, :64], atol=1e-3)
    np.testing.assert_array_equal(ours["emo"], ref["emo"])
    for key in ("audio", "visual", "text_ids", "text_mask", "labels"):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(ours[key], hash_cache[key], err_msg=key)


def test_fingerprint_names_the_rung_and_refuses_the_others_cache(
        monkeypatch, hash_cache, exported, port_run, tmp_path):
    from ultrafnd_git_tpu.data import cache as jax_cache

    fps = {"hash": port_cache.cache_fingerprint(TINY, 0, None)}
    plain = json.loads(fps["hash"])
    assert "text_rung" not in plain and "text_init" not in plain
    assert plain == {**json.loads(jax_cache.cache_fingerprint(TINY, 0, None)),
                     "align_init": "torch"}
    monkeypatch.setenv(CKPT, exported)
    assert port_cache.cache_fingerprint(TINY, 0, None) == fps["hash"]  # CKPT alone: hash
    monkeypatch.setenv(DEVICE, "1")
    fps["model_dir"] = port_cache.cache_fingerprint(TINY, 0, None)
    assert json.loads(fps["model_dir"])["text_rung"] == f"tower:{Path(exported).resolve()}"
    monkeypatch.setenv(CKPT, port_run)
    fps["slot"] = port_cache.cache_fingerprint(TINY, 0, None)
    assert json.loads(fps["slot"])["text_rung"] == f"tower:{Path(port_run).resolve()}/best"
    monkeypatch.delenv(CKPT)
    fps["seeded"] = port_cache.cache_fingerprint(TINY, 0, None)
    seeded = json.loads(fps["seeded"])
    assert (seeded["text_rung"], seeded["text_init"]) == ("tower-seeded", "torch")
    assert {k: v for k, v in seeded.items() if not k.startswith("text_")} == plain
    for name, fp in fps.items():
        path = str(tmp_path / f"{name}.npz")
        port_cache.save_cache(hash_cache, path, fingerprint=fp)
        for other, expected in fps.items():
            got = port_cache.load_cache(path, expected_fingerprint=expected)
            assert (got is not None) == (other == name), (name, other)


def test_predictor_under_the_trained_rung_matches_jax(monkeypatch, tower_ckpt, exported):
    """The CKPT rung in both Predictors' featurizers: prob_fake and the
    forensic scalars of JAX's Predictor within 1e-4, and rows that differ
    from the hash rung's."""
    from ultrafnd_git_tpu.serving import Predictor as JaxPredictor
    from ultrafnd_git_tpu_torch.predict import load_records
    from ultrafnd_git_tpu_torch.serving import Predictor

    records = load_records(Path(TINY) / "data_complete.json")[:24]
    hash_rows = Predictor(exported, device="cpu").predict(records)
    monkeypatch.setenv(DEVICE, "1")
    monkeypatch.setenv(CKPT, tower_ckpt["out"])
    ref = JaxPredictor(tower_ckpt["out"]).predict(records)
    monkeypatch.setenv(CKPT, exported)
    pred = Predictor(exported, device="cpu")
    try:
        rows = pred.predict(records)
        assert pred._encoders["text"]._tower().trained
    finally:
        pred.close()
    assert fa.launches == 0  # the CPU path
    assert [r["id"] for r in rows] == [r["id"] for r in ref]
    for key in ("prob_fake", "semantic_conflict", "temporal_delay", "emotion_intensity"):
        np.testing.assert_allclose([r[key] for r in rows], [r[key] for r in ref], atol=1e-4,
                                   err_msg=key)
    assert not np.allclose([r["prob_fake"] for r in rows],
                           [r["prob_fake"] for r in hash_rows], atol=1e-6)
