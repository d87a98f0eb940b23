"""PyTorch port, `--trainer integrated`, against the JAX integrated trainer.

Both trainers run on the CPU over the same feature cache (the JAX build of
the fakesv_tiny fixture, injected into the port's trainer), with the JAX
trainer's initial parameters carried across by the weight bridge
(`utils/transfer.port_state_dicts`, `gnn_model_state_dict_from_params`),
which maps gradient trees the same way. Tolerances, with dropout off: the
loss 1e-5, every gradient leaf within 1e-4 of its largest value; the
annealed threshold, the cosine learning rate of the first steps and the
batch graph's mask exactly.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ultrafnd_git_tpu_torch.kernels import adamw as aw
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.training import trainer_integrated as port
from ultrafnd_git_tpu_torch.utils.transfer import (
    gnn_model_state_dict_from_params,
    port_state_dicts,
)

REPO = Path(__file__).resolve().parents[1]
GRAD_REL = 1e-4  # each leaf's max |port - JAX| over its max |JAX|
BATCH = 8


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _keep_salt():
    prev = port_hashing.get_hash_salt()
    yield
    port_hashing.set_hash_salt(prev)


def _jax_trainer(root, out, **kw):
    from ultrafnd_git_tpu.training.trainer_integrated import (
        IntegratedForensicTrainer,
        IntegratedTrainConfig,
    )

    return IntegratedForensicTrainer(IntegratedTrainConfig(
        data_root=root, out_dir=str(out), batch_size=BATCH, epochs=2, cache_to_disk=False,
        log_metrics_jsonl=False, **kw))


def _bridged(jt, out, **kw):
    """A port trainer on the JAX trainer's cache, with its initial params."""
    pt = port.IntegratedForensicTrainer(port.IntegratedTrainConfig(
        out_dir=str(out), batch_size=BATCH, epochs=2, cache_to_disk=False,
        log_metrics_jsonl=False, **kw), cache=dict(jt.cache), device="cpu")
    params = jax.device_get(jt.state.params)
    sds = port_state_dicts(params, None, node_tau=10.0)
    if "gnn" in params:
        sds["gnn"] = gnn_model_state_dict_from_params(params["gnn"])
    assert set(sds) == set(pt.state.params)
    for part, mod in pt.state.params.items():
        mod.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sds[part].items()})
    return pt


@pytest.fixture(scope="module")
def pairs(fixture_data_root, tmp_path_factory):
    """{use_gnn: (JAX trainer, bridged port trainer)}; use_evidence on both,
    so a case can take the evidence out of each corpus."""
    out = {}
    for gnn in (True, False):
        jt = _jax_trainer(fixture_data_root, tmp_path_factory.mktemp("jt"), use_gnn=gnn,
                          use_evidence=True)
        out[gnn] = (jt, _bridged(jt, tmp_path_factory.mktemp("pt"), use_gnn=gnn,
                                 use_evidence=True))
    return out


def _ragged(trainer, valid):
    idx = np.asarray(trainer.train_idx[:BATCH], np.int64).copy()
    idx[valid:] = idx[valid - 1]  # the padding repeats the last row
    return idx, (np.arange(BATCH) < valid).astype(np.float32)


def _jax_loss_and_grads(jt, idx, mask, thr):
    def loss_fn(params):
        logits, _ = jt._forward(params, jnp.asarray(idx), jnp.float32(thr), jnp.asarray(mask),
                                jt.corpus, deterministic=True)
        return jt._loss_from_logits(logits, jt.corpus["labels"][idx], jnp.asarray(mask))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jt.state.params)
    grads = jax.device_get(grads)
    ref = port_state_dicts(grads, None, node_tau=10.0)
    if "gnn" in grads:
        ref["gnn"] = gnn_model_state_dict_from_params(grads["gnn"])
    return float(loss), ref


@pytest.mark.parametrize("gnn,weighting,evidence", [
    pytest.param(True, False, False, id="gnn"),
    pytest.param(False, False, False, id="no_gnn"),
    pytest.param(True, True, False, id="gnn_class_weighting"),
    pytest.param(True, False, True, id="gnn_use_evidence"),
])
def test_loss_and_gradients_match_jax(pairs, gnn, weighting, evidence):
    """A ragged batch (5 of 8 rows valid) at the second epoch's threshold:
    the padded rows leave the loss and the graph."""
    jt, pt = pairs[gnn]
    j_corpus, p_corpus = dict(jt.corpus), dict(pt.corpus)
    j_w, p_w = jt.class_w, pt.class_w
    if not evidence:
        jt.corpus.pop("evidence")
        pt.corpus.pop("evidence")
    if weighting:
        y = np.array(jt.cache["labels"])
        y[: len(y) // 3] = 1  # an unbalanced count, so the weights differ
        pos, neg = float((y == 1).sum()), float((y == 0).sum())
        w = [0.5 * (pos + neg) / neg, 0.5 * (pos + neg) / pos]
        jt.class_w = jnp.asarray(w, jnp.float32)
        pt.class_w = torch.tensor(w, dtype=torch.float32)
    try:
        idx, mask = _ragged(jt, valid=5)
        thr = pt.annealed_thresh(1)
        loss_ref, ref = _jax_loss_and_grads(jt, idx, mask, thr)
        loss, grads, p1 = pt.grads_of(torch.from_numpy(idx), torch.from_numpy(mask), thr)
    finally:
        jt.corpus, pt.corpus, jt.class_w, pt.class_w = j_corpus, p_corpus, j_w, p_w
    assert p1.shape == (BATCH,)
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5, atol=1e-6)
    assert set(grads) == ({"fusion", "clf", "gnn"} if gnn else {"fusion", "clf"})
    for part, leaves in grads.items():
        assert set(leaves) == {k for k in ref[part] if not k.endswith(".tau")}  # tau: a buffer
        for name, g in leaves.items():
            r = np.asarray(ref[part][name])
            scale = max(float(np.abs(r).max()), 1e-12)
            err = float(np.abs(g.numpy() - r).max())
            assert err <= GRAD_REL * scale, (part, name, err, scale)


def test_batch_graph_masks_padding_and_matches_jax(pairs):
    jt, pt = pairs[True]
    idx, mask = _ragged(jt, valid=5)
    thr = pt.annealed_thresh(0)
    adj = pt.batch_graph(torch.from_numpy(idx), torch.from_numpy(mask), thr).numpy()
    jb = np.asarray(jt.JAC)[idx][:, idx]
    ref = np.where((jb >= np.float32(thr)) & ~np.eye(BATCH, dtype=bool), jb, 0.0)
    ref = ref * mask[:, None] * mask[None, :]
    np.testing.assert_array_equal(adj, ref.astype(np.float32))
    assert not adj[5:].any() and not adj[:, 5:].any()  # the padding is out of the graph
    assert not np.diag(adj).any()
    np.testing.assert_array_equal(pt.corpus["jac"].numpy(), np.asarray(jt.JAC))


def test_threshold_and_cosine_lr_match_optax(pairs):
    jt, pt = pairs[True]
    for epoch in range(60):
        assert pt.annealed_thresh(epoch) == jt._annealed_thresh(epoch)
    steps = int(np.ceil(len(jt.train_idx) / BATCH))
    assert pt.decay_steps == max(1, 2 * steps)
    sched = jax.jit(optax.cosine_decay_schedule(2e-4, pt.decay_steps, alpha=0.1))
    for count in range(pt.decay_steps + 3):  # every step of the run, and past its end
        assert np.float32(pt.tx.schedule(count)) == np.asarray(sched(jnp.int32(count))), count
    # a longer schedule: XLA's f32 cosine is not correctly rounded
    # everywhere (the port's is), so at some steps the rates part by a few
    # f32 ulps (7 at most over 960 steps, 5.3e-7 relative)
    long = port.cosine_schedule(2e-4, 960, 0.1)
    sched = jax.jit(optax.cosine_decay_schedule(2e-4, 960, alpha=0.1))
    for count in range(0, 963, 7):
        ours, ref = float(long(count)), float(np.asarray(sched(jnp.int32(count))))
        assert abs(ours - ref) <= 1e-6 * ref, count


def test_every_update_is_one_fused_adamw_step(pairs):
    """The optimizer is FusedAdamW (K1 on a GPU); on the CPU it runs the
    plain update and the kernel counter stays 0."""
    _, pt = pairs[True]
    assert isinstance(pt.tx, aw.FusedAdamW) and pt.tx.grad_clip == 1.0
    assert pt.tx.schedule(0) == pytest.approx(2e-4)


@pytest.fixture(scope="module")
def fitted(fixture_data_root, tmp_path_factory):
    """A port run of two epochs from the raw fixture root (its own cache
    build), salted, so a resume can adopt the salt."""
    out = tmp_path_factory.mktemp("it_fit")
    cfg = port.IntegratedTrainConfig(data_root=fixture_data_root, out_dir=str(out),
                                     batch_size=BATCH, epochs=2, seed=0, hash_salt="s1")
    before = aw.launches
    t = port.IntegratedForensicTrainer(cfg, device="cpu")
    results = t.train()
    assert aw.launches == before  # the CPU path runs the plain update
    yield str(out), t, results
    shutil.rmtree(out, ignore_errors=True)


def test_train_and_test_write_finite_metrics_and_slots(fitted):
    out, t, results = fitted
    assert set(results) == {"test_loss", "test_acc", "test_auc"}
    assert all(np.isfinite(v) for v in results.values())
    steps = int(np.ceil(len(t.train_idx) / BATCH))
    assert t.state.step == 2 * steps == t.state.opt_state["count"]
    for slot in ("best", "latest"):
        meta = json.loads((Path(out) / slot / "meta.json").read_text())
        assert meta["trainer"] == "integrated" and meta["cfg"]["hash_salt"] == "s1"
    assert json.loads((Path(out) / "latest" / "meta.json").read_text())["epoch"] == 2
    rows = [json.loads(x) for x in (Path(out) / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert rows[1]["thr"] == pytest.approx(0.12 * 0.95)
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in rows)
    again = t.test()  # the best slot, tested again
    assert again == pytest.approx(results)


def test_resume_continues_and_adopts_the_salt(fitted, fixture_data_root, tmp_path, capsys):
    out, t, _ = fitted
    run = tmp_path / "run"
    shutil.copytree(out, run)
    cfg = port.IntegratedTrainConfig(data_root=fixture_data_root, out_dir=str(run),
                                     batch_size=BATCH, epochs=3, seed=0, resume=True)
    r = port.IntegratedForensicTrainer(cfg, device="cpu")
    assert "adopting it" in capsys.readouterr().out
    assert cfg.hash_salt == "s1" and port_hashing.get_hash_salt() == "s1"
    assert r.cache_source == "out_dir"  # the salted fingerprint matched: no rebuild
    assert r.start_epoch == 3 and r.state.step == t.state.step
    assert r.state.opt_state["count"] == t.state.opt_state["count"]
    for part, mod in r.state.params.items():
        for (name, p), q in zip(mod.named_parameters(), t.state.params[part].parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=f"{part}.{name}")
    # the schedule (over this run's 3 epochs) continues from the restored step
    steps = int(np.ceil(len(r.train_idx) / BATCH))
    assert r.decay_steps == 3 * steps and r.state.opt_state["count"] == 2 * steps
    assert r.tx.schedule(2 * steps) == port.cosine_schedule(2e-4, 3 * steps, 0.1)(2 * steps)
    r.train()
    assert r.state.step == 3 * steps
    meta = json.loads((run / "latest" / "meta.json").read_text())
    assert meta["epoch"] == 3 and meta["trainer"] == "integrated"


def test_bf16_compute_keeps_f32_params(fixture_data_root, tmp_path):
    cfg = port.IntegratedTrainConfig(data_root=fixture_data_root, out_dir=str(tmp_path),
                                     batch_size=BATCH, epochs=1, seed=0, bf16_compute=True,
                                     cache_to_disk=False)
    t = port.IntegratedForensicTrainer(cfg, device="cpu")
    assert t.state.params["fusion"].text_proj.dtype == torch.bfloat16
    idx, mask = _ragged(t, valid=BATCH)
    loss, p1 = t.train_step(idx, mask, t.annealed_thresh(0))
    assert np.isfinite(float(loss)) and p1.dtype == torch.float32
    for mod in t.state.params.values():
        assert all(p.dtype == torch.float32 for p in mod.parameters())
    for key in ("mu", "nu"):
        assert all(v.dtype == torch.float32 for d in t.state.opt_state[key].values()
                   for v in d.values())


def test_cli_warns_on_v2_flags_and_refuses_export(fixture_data_root, tmp_path):
    code = (
        "import sys, runpy\n"
        "sys.argv = ['train'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('ultrafnd_git_tpu_torch.train', run_name='__main__')\n"
        "finally:\n"
        "    print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'ultrafnd_git_tpu')))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO), "ULTRAFND_DISABLE_HF": "1"}
    base = [sys.executable, "-c", code, "--trainer", "integrated", "--data_root",
            fixture_data_root, "--out_dir", str(tmp_path / "cli"), "--epochs", "1",
            "--batch_size", "8", "--device", "cpu"]
    run = subprocess.run(base + ["--train_text_tower", "--grad_accum", "2",
                                 "--select_metric", "f1"],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert ("⚠️  --train_text_tower --select_metric --grad_accum apply to the v2 trainer "
            "only; the integrated trainer ignores them") in run.stdout
    assert "==== Final Results ====" in run.stdout
    for key in ("Test Loss", "Test Acc", "Test Auc"):
        assert f"\n{key}: " in run.stdout
    assert "LOADED []" in run.stdout
    meta = json.loads((tmp_path / "cli" / "best" / "meta.json").read_text())
    assert meta["trainer"] == "integrated"
    refused = subprocess.run(base + ["--export_model_dir", str(tmp_path / "m")],
                             capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert refused.returncode != 0 and "cannot be served" in refused.stderr


def test_serving_refuses_integrated_checkpoints(fitted, tmp_path):
    """The port's export of a trained out_dir, its Predictor on a model
    directory naming the integrated trainer, and scripts/export_torch_model.py
    on a JAX integrated out_dir all raise the JAX Predictor's error."""
    import importlib.util

    from ultrafnd_git_tpu_torch.serving import Predictor, write_seeded_model_dir
    from ultrafnd_git_tpu_torch.utils.transfer import export_trained

    out, _, _ = fitted
    msg = "written by the 'integrated' trainer; Predictor serves v2 checkpoints only"
    with pytest.raises(ValueError, match=msg):
        export_trained(out, "best", str(tmp_path / "m"))
    meta = {
        "trainer": "integrated",
        "cfg": {},
        "fusion": {"hidden": 16, "use_gnn": False, "gnn_dim": 8, "text_dim": 768,
                   "audio_dim": 128, "visual_dim": 512, "temporal_dim": 256},
        "classifier": {"hidden": 8, "num_classes": 2, "use_aux": True, "aux_dim": 2,
                       "node_trees": 1, "node_depth": 1, "node_tau": 10.0,
                       "temperature_init": 1.0},
        "gnn": None, "align": {"in_dim": 768, "out_dim": 256}, "text_tower": None,
    }
    n = 4
    rng = np.random.default_rng(0)
    corpus = {"ids": np.array([f"c{i}" for i in range(n)], dtype=object),
              "labels": np.zeros(n, np.int64),
              **{k: rng.standard_normal((n, w)).astype(np.float32) for k, w in
                 (("text", 768), ("audio", 128), ("visual", 512), ("temporal", 256),
                  ("aux", 2))},
              "ocr_sets": [set() for _ in range(n)],
              "split": (np.arange(n), np.arange(0), np.arange(0))}
    write_seeded_model_dir(str(tmp_path / "md"), meta, corpus)
    with pytest.raises(ValueError, match=msg):
        Predictor(str(tmp_path / "md"), device="cpu")
    # a JAX out_dir whose best slot the JAX integrated trainer wrote
    jax_out = tmp_path / "jax_out"
    (jax_out / "best").mkdir(parents=True)
    (jax_out / "best" / "meta.json").write_text(json.dumps({"trainer": "integrated", "cfg": {}}))
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(ValueError, match=msg):
        mod.export(str(jax_out), str(tmp_path / "m2"))
