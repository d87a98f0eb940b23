"""PyTorch port, `bf16_compute` training and the trainer's featurization
repairs, against the JAX package on the CPU.

JAX's `flash_attention(backend="auto")` sends S < 512 to XLA's attention,
so the JAX tower at S = 64 never runs the Pallas bf16 backward; the port
sends every S to its kernels. The references here are therefore JAX towers
cloned with `attention_backend="interpret"`: the Pallas bf16 forward and
backward (K2, K3, K4) in interpret mode. Weights cross by
`utils/transfer`; inputs are seeded numpy arrays; dropout is off.

(c) The bf16 tower's gradient (loss = sum of pooled * w) against `jax.grad`
of the JAX bf16 tower: every leaf within 3e-2 of its largest value (the
bias leaves, whose sums round in other orders, come closest to it).
(d) The whole step: `ForensicTrainer(bf16_compute=True).grads_of` against
`jax.grad` of the JAX trainer with `bf16_compute=True`, its tower cloned as
above. The loss within 1e-4. Every leaf within 5e-2 in relative L2 norm
(||port - ref|| / ||ref||; measured 3.9e-2) and within 1e-1 of its largest
value (measured 7.5e-2). The max-element bound of 5e-2 does not hold
against this reference: in JAX's autodiff the gradient of a bf16 Dense's
bias is a `reduce_sum` in bf16 (the transpose of its broadcast add), so
the reference's own bias gradients carry bf16 accumulation error that
grows with the positions summed (the JAX bf16 gradient of the tower's
mlp_out bias is 7.7e-2 of its largest value from the f32 one at these 8
rows and 53% at 32; the port's, summed in f32, stays within 6.4e-2 at 32
rows; `scripts/bf16_grad_envelope.py` prints these). Then one JAX bf16
epoch (fit) carried to the port: the val rows' labels agree and
prob_fake and the val AUC within 2e-2; and the port's own
one-epoch bf16 fit writes finite losses and both slots, launches nothing
on the CPU, and `--eval_only` adopts `bf16_compute` from the slot.
(e) ROADMAP §3.1 and §3.2: a model directory whose meta says
`hash_salt="s1"` and names an OCR phrase pickle; the port trains from it,
exports and serves: the exported cfg carries both fields, the Predictor's
rows for new records equal the JAX featurizer's under salt s1 with that
pickle, and the run's cache is a byte-identical copy of the directory's; a
stale features version is decided as the JAX loader decides it.
"""
import filecmp
import json
import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu.data.cache import build_feature_cache, make_encoders
from ultrafnd_git_tpu.data.cache import load_cache as jax_load_cache
from ultrafnd_git_tpu.models.transformer import TextTransformer as JaxTextTransformer
from ultrafnd_git_tpu.ops import hashing as jax_hashing
from ultrafnd_git_tpu.training.metrics import aggregate_epoch_metrics as jax_metrics
from ultrafnd_git_tpu_torch.data import cache as port_cache
from ultrafnd_git_tpu_torch.kernels import adamw as aw
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.predict import load_records
from ultrafnd_git_tpu_torch.training import trainer as port
from ultrafnd_git_tpu_torch.training.metrics import aggregate_epoch_metrics
from ultrafnd_git_tpu_torch.utils.transfer import export_trained, port_state_dicts, tower_state_dict

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
TOWER = dict(train_text_tower=True, text_tower_depth=1, text_tower_heads=4)
TOWER_REL = 3e-2
STEP_L2 = 5e-2
STEP_MAX = 1e-1
FIT_PROB = 2e-2


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Delete the test's run directories when it ends: one checkpoint's state.pt is
    ~150 MB, and what the tests leave behind would otherwise fill the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _keep_salts():
    """The trainer and the Predictor set each package's process-wide salt."""
    prev = port_hashing.get_hash_salt(), jax_hashing.get_hash_salt()
    yield
    port_hashing.set_hash_salt(prev[0])
    jax_hashing.set_hash_salt(prev[1])


def _leaf_gaps(ours, ref):
    """{part.name: (max|d| / max|ref|, ||d|| / ||ref||)} over every leaf."""
    out = {}
    for part, leaves in ours.items():
        for name, g in leaves.items():
            r = np.asarray(ref[part][name], np.float32)
            d = np.asarray(g, np.float32) - r
            out[f"{part}.{name}"] = (np.abs(d).max() / max(np.abs(r).max(), 1e-30),
                                     np.linalg.norm(d) / max(np.linalg.norm(r), 1e-30))
    return out


# ---------------------------------------------------------------------------
# (c) the tower

def test_bf16_tower_gradient_matches_jax_interpret():
    width, heads, vocab, seq, b = 384, 2, 512, 16, 4  # D = 192, the fixture tower's width
    jmod = JaxTextTransformer(width=width, depth=2, heads=heads, vocab_size=vocab, max_len=seq,
                              gelu="tanh", dtype=jnp.bfloat16, attention_backend="interpret")
    rng = np.random.default_rng(1)
    ids = rng.integers(1, vocab, size=(b, seq)).astype(np.int32)
    lengths = np.array([seq, 5, 1, 11])  # full and padded records
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.float32)
    ids = ids * mask.astype(np.int32)
    w = rng.standard_normal((b, width)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask),
                       deterministic=True)["params"]
    ref = tower_state_dict(jax.device_get(jax.grad(lambda p: (jmod.apply(
        {"params": p}, jnp.asarray(ids), jnp.asarray(mask), deterministic=True) * w).sum())(params)))

    tower = TextTransformer(width=width, depth=2, heads=heads, vocab_size=vocab, max_len=seq,
                            gelu="tanh", dtype=torch.bfloat16)
    tower.load_state_dict({k: torch.from_numpy(v) for k, v in
                           tower_state_dict(jax.device_get(params)).items()})
    (tower(torch.from_numpy(ids).long(), torch.from_numpy(mask)) * torch.from_numpy(w)).sum().backward()
    gaps = _leaf_gaps({"t": {n: p.grad for n, p in tower.named_parameters()}}, {"t": ref})
    assert len(gaps) == len(ref)
    worst = max(gaps.items(), key=lambda kv: kv[1][0])
    assert worst[1][0] <= TOWER_REL, worst


def test_bf16_tower_fully_masked_record_has_finite_gradients():
    from ultrafnd_git_tpu_torch.models.initializers import seeded_init_

    tower = TextTransformer(width=128, depth=2, heads=2, vocab_size=64, max_len=16,
                            dtype=torch.bfloat16)
    seeded_init_(tower, torch.Generator().manual_seed(0))
    ids = torch.randint(1, 64, (3, 16), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(3, 16)
    mask[1, 5:] = 0
    mask[2] = 0  # an empty record
    (tower(ids, mask) * torch.randn(3, 128, generator=torch.Generator().manual_seed(2))).sum().backward()
    for n, p in tower.named_parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), n


# ---------------------------------------------------------------------------
# (d) the whole step and a one-epoch fit

@pytest.fixture(scope="module")
def jax_bf16(fixture_data_root, tmp_path_factory):
    """The JAX trainer with bf16_compute on the fixture: its initial params,
    one fitted epoch (with its own XLA attention, as it trains), then its
    tower cloned onto the Pallas bf16 kernels in interpret mode."""
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig

    out = tmp_path_factory.mktemp("jax_bf16")
    cfg = TrainConfig(data_root=fixture_data_root, out_dir=str(out), batch_size=8, epochs=1,
                      seed=0, log_metrics_jsonl=False, bf16_compute=True, **TOWER)
    jt = ForensicTrainer(cfg)
    init = jax.device_get(jt.state.params)
    jt.fit()
    jt.text_tower = jt.text_tower.clone(attention_backend="interpret")
    yield jt, init, jax.device_get(jt.state.params)
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def port_bf16(jax_bf16, tmp_path_factory):
    """A port trainer with bf16_compute whose cache comes from the JAX run's
    out_dir (a model dir without meta.json: nothing to adopt)."""
    out = tmp_path_factory.mktemp("port_bf16")
    jt = jax_bf16[0]
    pt = port.ForensicTrainer(port.TrainConfig(out_dir=str(out), model_dir=jt.cfg.out_dir,
                                               batch_size=8, epochs=1, seed=0,
                                               bf16_compute=True, **TOWER), device="cpu")
    yield pt
    shutil.rmtree(out, ignore_errors=True)


def _load(pt, params):
    for part, sd in port_state_dicts(params, None, node_tau=10.0).items():
        pt.state.params[part].load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()})


def test_bf16_step_loss_and_gradients_match_jax(jax_bf16, port_bf16):
    jt, init, _ = jax_bf16
    pt = port_bf16
    assert pt.state.params["fusion"].text_proj.dtype == torch.bfloat16
    assert pt.state.params["gnn"].lin1.weight.dtype == torch.float32
    _load(pt, init)
    n, valid = 8, 5
    idx = np.asarray(jt.tr_idx[:n], np.int32).copy()
    idx[valid:] = idx[valid - 1]  # ragged batch: the padding repeats the last row
    mask = (np.arange(n) < valid).astype(np.float32)

    def loss_fn(params):
        ce, _, _ = jt._forward(params, jnp.asarray(idx), jt.corpus, deterministic=True)
        m = jnp.asarray(mask)
        return (ce * m).sum() / jnp.maximum(m.sum(), 1.0)

    loss_ref, g = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, init))
    ref = port_state_dicts(jax.device_get(g), None, node_tau=10.0)
    before = (fa.bf16_launches, fa.bwd_bf16_launches)
    loss, grads, (p1, forensic) = pt.grads_of(torch.from_numpy(idx).long(), torch.from_numpy(mask))
    assert (fa.bf16_launches, fa.bwd_bf16_launches) == before
    assert p1.shape == (n,) and forensic.shape == (3, n)
    assert abs(float(loss) - float(loss_ref)) <= 1e-4
    gaps = _leaf_gaps({part: {k: v.numpy() for k, v in d.items()} for part, d in grads.items()}, ref)
    assert len(gaps) == sum(len(list(m.parameters())) for m in pt.state.params.values())
    for name, (rel_max, rel_l2) in gaps.items():
        assert all(np.isfinite((rel_max, rel_l2))), name
        assert rel_l2 <= STEP_L2 and rel_max <= STEP_MAX, (name, rel_max, rel_l2)
    for part, leaves in grads.items():
        for name, t in leaves.items():
            assert t.dtype == torch.float32, (part, name)  # f32 master gradients


def test_bf16_fitted_epoch_val_labels_and_metrics_match_jax(jax_bf16, port_bf16):
    """The JAX trainer's one-epoch bf16 fit, carried to the port: the val
    rows through each package's bf16 eval path."""
    jt, _, fitted = jax_bf16
    pt = port_bf16
    _load(pt, fitted)
    va = np.asarray(jt.va_idx, np.int32)
    _, jp, _ = jax.jit(lambda p, i: jt._forward(p, i, jt.corpus, deterministic=True))(
        jax.tree.map(jnp.asarray, fitted), jnp.asarray(va))
    jp = np.asarray(jp, np.float64)
    _, p1, _ = pt.eval_step(pt.state.params, va, np.ones(len(va), np.float32))
    p1 = p1.numpy().astype(np.float64)
    y = np.asarray(jt.cache["labels"])[va]
    assert np.isfinite(p1).all() and np.abs(p1 - jp).max() <= FIT_PROB
    assert ((p1 >= 0.5) == (jp >= 0.5)).all()
    ours, ref = aggregate_epoch_metrics(y, p1), jax_metrics(y, jp)
    assert ours["accuracy"] == pytest.approx(ref["accuracy"], abs=1e-12)
    assert abs(ours["auc"] - ref["auc"]) <= FIT_PROB


def test_bf16_port_fit_and_eval_only_adoption(jax_bf16, tmp_path):
    jt = jax_bf16[0]
    out = tmp_path / "run"
    counters = (fa.launches, fa.bf16_launches, fa.bwd_launches, fa.bwd_bf16_launches, aw.launches)
    t = port.ForensicTrainer(port.TrainConfig(out_dir=str(out), model_dir=jt.cfg.out_dir,
                                              batch_size=16, epochs=1, seed=0,
                                              bf16_compute=True, **TOWER), device="cpu")
    t.fit()
    assert (fa.launches, fa.bf16_launches, fa.bwd_launches, fa.bwd_bf16_launches,
            aw.launches) == counters  # the plain path launches no kernel
    log = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite([log[0]["train_loss"], log[0]["val_loss"]]).all()
    for slot in ("best", "latest"):
        assert json.loads((out / slot / "meta.json").read_text())["cfg"]["bf16_compute"] is True
    for mod in t.state.opt_state["mu"].values():
        assert all(v.dtype == torch.float32 for v in mod.values())
    e = port.ForensicTrainer(port.TrainConfig(out_dir=str(out), model_dir=jt.cfg.out_dir,
                                              batch_size=16, eval_only=True, **TOWER),
                             device="cpu")
    assert e.cfg.bf16_compute is True  # adopted from the best slot
    assert e.state.params["text_tower"].dtype == torch.bfloat16
    res = e.test()
    assert all(np.isfinite(v) for v in res.values())


# ---------------------------------------------------------------------------
# (e) the repairs: the corpus's salt and OCR pickle, the cache copy and its
# reuse guards

def _salted_model_dir(root: Path, pkl: Path) -> None:
    """A seeded model dir (no tower) whose meta says hash_salt="s1" and
    names an OCR phrase pickle, over a 40-record corpus."""
    from ultrafnd_git_tpu_torch.serving import write_seeded_model_dir

    meta = {
        "cfg": {"hash_salt": "s1", "ocr_phrase_pkl": str(pkl), "train_text_tower": False,
                "use_gnn": True, "gnn_overlap_thresh": 0.12},
        "fusion": {"hidden": 64, "use_gnn": True, "gnn_dim": 16, "text_dim": 768,
                   "audio_dim": 128, "visual_dim": 512, "temporal_dim": 32},
        "classifier": {"hidden": 32, "num_classes": 2, "use_aux": True, "aux_dim": 2,
                       "node_trees": 2, "node_depth": 3, "node_tau": 10.0,
                       "temperature_init": 1.0},
        "gnn": {"in_dim": 416 - 64 + 32, "hid": 32, "out_dim": 16},
        "align": {"in_dim": 768, "out_dim": 32},
        "text_tower": None,
    }
    rng = np.random.default_rng(3)
    n = 40
    words = [f"w{i}" for i in range(30)]
    corpus = {
        "ids": np.array([f"c{i}" for i in range(n)], dtype=object),
        "labels": np.arange(n) % 2,
        **{key: rng.standard_normal((n, w)).astype(np.float32) for key, w in
           (("text", 768), ("audio", 128), ("visual", 512), ("temporal", 32),
            ("aux", 2), ("evidence", 3))},
        "text_ids": np.zeros((n, 64), np.int32),
        "text_mask": np.zeros((n, 64), np.float32),
        "ocr_sets": [set(rng.choice(words, size=5, replace=False)) for _ in range(n)],
        "split": (np.arange(24), np.arange(24, 32), np.arange(32, n)),
    }
    # the phrase pickle in the format data/ocr.py reads
    with open(pkl, "wb") as fh:
        pickle.dump({"phrase_sets": {f"c{i}": corpus["ocr_sets"][i] for i in range(n)},
                     "freqs": {f"c{i}": {t: 1 for t in corpus["ocr_sets"][i]} for i in range(n)}},
                    fh)
    write_seeded_model_dir(str(root), meta, corpus)


def test_salted_model_dir_trains_exports_and_serves_under_its_salt(tmp_path, capsys):
    from ultrafnd_git_tpu_torch.serving import Predictor

    model_dir, pkl, out = tmp_path / "model", tmp_path / "phrases.pkl", tmp_path / "run"
    _salted_model_dir(model_dir, pkl)
    t = port.ForensicTrainer(port.TrainConfig(out_dir=str(out), model_dir=str(model_dir),
                                              batch_size=16, epochs=1, seed=0), device="cpu")
    assert "featurized with hash_salt='s1'; adopting it" in capsys.readouterr().out
    assert (t.cfg.hash_salt, t.cfg.ocr_phrase_pkl) == ("s1", str(pkl))
    assert port_hashing.get_hash_salt() == "s1"
    # the cache is copied byte for byte (fingerprint and feature version kept)
    assert filecmp.cmp(out / "feature_cache.npz", model_dir / "feature_cache.npz", shallow=False)
    t.fit()
    served = export_trained(str(out), "best", str(tmp_path / "served"), str(model_dir))
    cfg = json.loads((served / "meta.json").read_text())["cfg"]
    assert cfg["hash_salt"] == "s1" and cfg["ocr_phrase_pkl"] == str(pkl)

    records = load_records(FIXTURE)[:20]
    port_hashing.set_hash_salt("")  # the Predictor sets the salt it serves under
    pred = Predictor(str(served), device="cpu")
    try:
        ours = pred.featurize(records)
        rows = pred.predict(records)
    finally:
        pred.close()
    assert all(np.isfinite(r["prob_fake"]) for r in rows)

    class Raw:
        def __len__(self):
            return len(records)

        def get_item(self, i):
            r = records[i]
            return {"id": r.get("video_id") or f"q_{i}", "title": r.get("title") or "",
                    "ocr": r.get("ocr") or "", "comments": list(r.get("comments") or []),
                    "label": 0}

    jax_hashing.set_hash_salt("s1")
    ref = build_feature_cache(Raw(), ocr_phrase_pkl=str(pkl),
                              encoders=make_encoders(seed=0, with_evidence=False),
                              with_evidence=False, with_align=False)
    n = len(records)
    assert list(ours["ids"][:n]) == list(ref["ids"])
    for key in ("text", "audio", "visual", "emo"):
        np.testing.assert_array_equal(ours[key][:n], ref[key], err_msg=key)
    assert ours["ocr_sets"][:n] == ref["ocr_sets"]


def _stale_copy(src: Path, dst: Path, how: str) -> None:
    """src's cache with features version 2, stated by its `features_version`
    or (older files) only inside its JSON fingerprint."""
    with np.load(src, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if how == "features_version":
        arrays["features_version"] = np.int64(2)
    else:
        arrays.pop("features_version")
        arrays["fingerprint"] = np.str_(json.dumps({"data_root": "x", "seed": 0, "features": 2}))
    with open(dst, "wb") as fh:
        np.savez_compressed(fh, **arrays)


@pytest.mark.parametrize("how", ["features_version", "fingerprint"])
def test_stale_features_version_is_decided_as_jax_decides(tmp_path, how, capsys):
    model_dir, pkl = tmp_path / "model", tmp_path / "phrases.pkl"
    _salted_model_dir(model_dir, pkl)
    stale = tmp_path / "stale.npz"
    _stale_copy(model_dir / "feature_cache.npz", stale, how)
    # a fresh run: both loaders refuse it (None), so the caller rebuilds
    assert jax_load_cache(str(stale)) is None
    assert port_cache.load_cache(str(stale)) is None
    # eval_only / resume: both reuse it, with the warning
    capsys.readouterr()
    ref = jax_load_cache(str(stale), stale_features="reuse")
    said_jax = capsys.readouterr().out
    ours = port_cache.load_cache(str(stale), stale_features="reuse")
    said = capsys.readouterr().out
    assert "reusing it because the checkpoint" in said_jax and "reusing it because the checkpoint" in said
    for key in ("labels", "text", "audio", "visual", "temporal", "aux", "text_ids", "text_mask"):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    assert ours["ocr_sets"] == ref["ocr_sets"] and list(ours["ids"]) == list(ref["ids"])

    # through the trainer: a model dir's stale cache is not taken, so a fresh
    # run falls to the data root (none here: it raises); out_dir's own stale
    # cache is reused under --eval_only
    shutil.copyfile(stale, model_dir / "feature_cache.npz")
    with pytest.raises(FileNotFoundError, match="no data_root"):
        port.ForensicTrainer(port.TrainConfig(out_dir=str(tmp_path / "fresh"),
                                              model_dir=str(model_dir)), device="cpu")
    run = tmp_path / "run"
    run.mkdir()
    shutil.copyfile(stale, run / "feature_cache.npz")
    e = port.ForensicTrainer(port.TrainConfig(out_dir=str(run), model_dir=str(model_dir),
                                              eval_only=True), device="cpu")
    assert e.n_total == 40
