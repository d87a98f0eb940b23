"""PyTorch port, the training slice as a whole, against the JAX trainer.

The JAX trainer is built on the shared `tower_ckpt` fixture's cache
(depth 1, 4 heads of 192, batch 8); its initial params (after the GCN
pretrain) cross to the port's trainer through the bridge
(`utils/transfer.port_state_dicts`, which maps gradient trees the same
way). The port's trainer takes its cache from the model directory that
`scripts/export_torch_model.py` writes from that checkpoint, the route a
user takes from a JAX out_dir. Everything runs on the CPU, where the
port's kernel wrappers run their plain versions (the counters stay 0).

Tolerances, with dropout off: loss and every gradient leaf atol 1e-5,
rtol 1e-4.
"""
import importlib.util
import json
from dataclasses import asdict
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch.kernels import adamw as aw
from ultrafnd_git_tpu_torch.kernels import flash_attention as fa
from ultrafnd_git_tpu_torch.training import trainer as port
from ultrafnd_git_tpu_torch.utils.transfer import port_state_dicts

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny" / "data_complete.json"
TOL = dict(atol=1e-5, rtol=1e-4)
TOWER = dict(train_text_tower=True, text_tower_depth=1, text_tower_heads=4)
TEST_KEYS = {"test_loss", "test_acc", "test_auc", "test_precision", "test_recall",
             "test_f1", "test_cmcs", "test_dfdr"}


@pytest.fixture(scope="module")
def model_dir(tower_ckpt, tmp_path_factory):
    """scripts/export_torch_model.py's output: the port trainer's --model_dir."""
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path_factory.mktemp("torch_model")
    mod.export(tower_ckpt["out"], str(out))
    return str(out)


@pytest.fixture(scope="module")
def jax_trainer(tower_ckpt, fixture_data_root, tmp_path_factory):
    from ultrafnd_git_tpu.data.cache import load_cache
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig

    cache = load_cache(os.path.join(tower_ckpt["out"], "feature_cache.npz"))
    cfg = TrainConfig(data_root=fixture_data_root, out_dir=str(tmp_path_factory.mktemp("jt")),
                      batch_size=8, epochs=1, seed=0, log_metrics_jsonl=False, **TOWER)
    return ForensicTrainer(cfg, cache=cache)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Checkpoints of the tower model are hundreds of MB: drop each test's
    files when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _port_cfg(out_dir, model_dir, **kw):
    base = dict(out_dir=str(out_dir), model_dir=model_dir, batch_size=8, epochs=2, seed=0,
                **TOWER)
    base.update(kw)
    return port.TrainConfig(**base)


@pytest.fixture(scope="module")
def bridged(jax_trainer, model_dir, tmp_path_factory):
    """A port trainer carrying the JAX trainer's initial params."""
    pt = port.ForensicTrainer(_port_cfg(tmp_path_factory.mktemp("pt"), model_dir),
                              device="cpu")
    sds = port_state_dicts(jax.device_get(jax_trainer.state.params), None, node_tau=10.0)
    assert set(sds) == set(pt.state.params)
    for part, mod in pt.state.params.items():
        mod.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sds[part].items()})
    return pt


def _rows(trainer, n, valid):
    idx = np.asarray(trainer.tr_idx[:n], np.int32).copy()
    idx[valid:] = idx[valid - 1]  # ragged batch: the padding repeats the last row
    mask = (np.arange(n) < valid).astype(np.float32)
    return idx, mask


def _jax_loss_and_grads(jt, idx, mask):
    def loss_fn(params):
        ce, _, _ = jt._forward(params, jnp.asarray(idx), jt.corpus, deterministic=True)
        m = jnp.asarray(mask)
        return (ce * m).sum() / jnp.maximum(m.sum(), 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jt.state.params)
    return float(loss), port_state_dicts(jax.device_get(grads), None, node_tau=10.0)


def _assert_grads_match(ours, ref, tol=TOL):
    for part, leaves in ours.items():
        for name, g in leaves.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(ref[part][name]),
                                       err_msg=f"{part}.{name}", **tol)


@pytest.mark.parametrize("accum,evidence", [
    pytest.param(1, False, id="batch_8"),
    pytest.param(4, False, id="grad_accum_4_vs_batch_32"),
    pytest.param(1, True, id="batch_8_use_evidence"),
])
def test_loss_and_gradients_match_jax(jax_trainer, bridged, accum, evidence):
    """With `evidence`, both trainers feed the same cache's scorer outputs
    to the fusion gates, as each does under use_evidence (JAX
    `trainer.py:450-451`, `:875-876`)."""
    n = 8 * accum
    idx, mask = _rows(jax_trainer, n, valid=n - 3)
    jt_corpus = jax_trainer.corpus
    if evidence:
        ev = np.asarray(jax_trainer.cache["evidence"], np.float32)
        assert all(ev[:, j].std() > 0 for j in range(3))
        jax_trainer.corpus = {**jt_corpus, "evidence": jnp.asarray(ev)}
        bridged.corpus["evidence"] = torch.from_numpy(np.asarray(bridged.cache["evidence"]))
        np.testing.assert_array_equal(bridged.corpus["evidence"].numpy(), ev)
    bridged.cfg.grad_accum = accum
    try:
        loss_ref, grads_ref = _jax_loss_and_grads(jax_trainer, idx, mask)
        loss, grads, (p1, forensic) = bridged.grads_of(
            torch.from_numpy(idx).long(), torch.from_numpy(mask))
    finally:
        bridged.cfg.grad_accum = 1
        jax_trainer.corpus = jt_corpus
        bridged.corpus.pop("evidence", None)
    assert p1.shape == (n,) and forensic.shape == (3, n)
    if evidence:  # the gates read the cached scorer outputs, not the proxies
        rows = np.asarray(bridged.cache["evidence"])[idx]
        np.testing.assert_array_equal(forensic[0].numpy(), rows[:, 0])
        np.testing.assert_array_equal(forensic[2].numpy(), rows[:, 1])
    np.testing.assert_allclose(float(loss), loss_ref, **TOL)
    assert set(grads) == {"fusion", "clf", "gnn", "text_tower"}
    n_leaves = sum(len(d) for d in grads.values())
    assert n_leaves == sum(len(list(m.parameters())) for m in bridged.state.params.values())
    _assert_grads_match(grads, grads_ref)


def test_pretrain_loss_gradient_matches_jax(jax_trainer, bridged):
    jt = jax_trainer
    head = (np.random.default_rng(7).standard_normal((128, 1)) / np.sqrt(128)).astype(np.float32)

    def loss_fn(p):  # trainer.py _pretrain_gnn's loss, dropout off
        z = jt.gnn.apply({"params": p}, jt.XG, jt.A_NORM, deterministic=True,
                         normalize=False, ax=jt.AX)
        pred = jax.nn.sigmoid(z @ head)
        target = jt.A_NORM.sum(axis=-1, keepdims=True) / max(1.0, float(jt.n_total))
        return jnp.mean((pred - target) ** 2)

    loss_ref, g_ref = jax.value_and_grad(loss_fn)(jt.state.params["gnn"])
    gnn = bridged.state.params["gnn"]
    loss = bridged.pretrain_loss(gnn, torch.from_numpy(head))
    names = [n for n, _ in gnn.named_parameters()]
    grads = torch.autograd.grad(loss, list(gnn.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), **TOL)
    ref = port_state_dicts({"fusion": jt.state.params["fusion"], "clf": jt.state.params["clf"],
                            "gnn": jax.device_get(g_ref)}, None, 10.0)["gnn"]
    _assert_grads_match({"gnn": dict(zip(names, grads))}, {"gnn": ref})


def test_epoch_batch_orders_match_jax(jax_trainer, model_dir, tmp_path):
    """Two train epochs of each trainer, the steps replaced by recorders:
    the (chunk, mask) sequences are identical."""
    jt = jax_trainer
    seen = {"jax": [], "port": []}

    def jax_epoch(state, ch, ms, corpus):
        seen["jax"].extend(zip(np.asarray(ch).tolist(), np.asarray(ms).tolist()))
        s, b = np.asarray(ch).shape
        return state, (np.zeros(s), np.full((s, b), 0.5), np.zeros((s, 3, b)))

    saved = jt._train_epoch
    jt._train_epoch = jax_epoch
    try:
        np.random.seed(jt.cfg.seed)  # what the JAX trainer's __init__ does
        for epoch in (1, 2):
            jt._epoch_loop(jt.tr_idx, "train", epoch=epoch)
    finally:
        jt._train_epoch = saved

    pt = port.ForensicTrainer(_port_cfg(tmp_path, model_dir), device="cpu")

    def port_step(idx, mask):
        seen["port"].append((np.asarray(idx).tolist(), np.asarray(mask).tolist()))
        n = len(idx)
        return torch.zeros(()), torch.full((n,), 0.5), torch.zeros((3, n))

    pt.train_step = port_step
    for _ in (1, 2):
        pt._epoch_loop(pt.tr_idx, "train")
    assert len(seen["port"]) == 2 * -(-len(pt.tr_idx) // 8)
    assert seen["port"] == seen["jax"]


@pytest.fixture(scope="module")
def fitted(model_dir, tmp_path_factory):
    """A port trainer after fit() for 1 epoch on the CPU (fused_adamw on)."""
    out = tmp_path_factory.mktemp("fit") / "run"
    counters = (fa.launches, fa.bwd_launches, aw.launches)
    t = port.ForensicTrainer(_port_cfg(out, model_dir, batch_size=16, epochs=1,
                                       fused_adamw=True), device="cpu")
    t.fit()
    # the plain path launches no kernel: every counter stays 0
    assert (fa.launches, fa.bwd_launches, aw.launches) == counters == (0, 0, 0)
    yield t, out
    shutil.rmtree(out, ignore_errors=True)


def _copy_run(fitted, tmp_path):
    """A copy of the fitted out_dir whose large files (state.pt, the cache)
    are symlinks: a new save replaces the link, never the original."""
    run = tmp_path / "run"
    shutil.copytree(fitted[1], run, copy_function=lambda src, dst: (
        os.symlink(src, dst) if Path(src).suffix in (".pt", ".npz")
        else shutil.copy2(src, dst)))
    return run


@pytest.fixture(scope="module")
def cli_run(fitted, model_dir, tmp_path_factory):
    """The training CLI in a fresh process on the CPU: --resume trains the
    second epoch of a copy of the fitted run, tests it and exports it; then
    the process lists the modules of jax and of the JAX package it loaded."""
    tmp = tmp_path_factory.mktemp("cli")
    run = _copy_run(fitted, tmp)
    code = (
        "import sys\n"
        "from ultrafnd_git_tpu_torch.train import main\n"
        f"main(['--model_dir', {model_dir!r}, '--out_dir', {str(run)!r},"
        " '--epochs', '2', '--batch_size', '16', '--resume', '--train_text_tower',"
        " '--text_tower_depth', '1', '--text_tower_heads', '4', '--fused_adamw',"
        f" '--device', 'cpu', '--export_model_dir', {str(tmp / 'm')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ultrafnd_git_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=tmp, timeout=300)
    yield proc, run, tmp / "m"
    shutil.rmtree(tmp, ignore_errors=True)


def test_fit_writes_finite_losses_and_both_slots(fitted):
    t, out = fitted
    log = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in log] == [1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in log)
    for slot in ("best", "latest"):
        meta = json.loads((out / slot / "meta.json").read_text())
        assert meta["trainer"] == "v2" and meta["cfg"]["fused_adamw"] is True
        assert set(meta) >= {"epoch", "best_val_auc", "no_improve", "cfg", "model"}
        assert (out / slot / "state.pt").exists()
    latest = json.loads((out / "latest" / "meta.json").read_text())
    assert latest["epoch"] == 1 and len(latest["np_random_state"][1]) == 624
    res = t.test()
    assert set(res) == TEST_KEYS and all(np.isfinite(v) for v in res.values())


def test_resume_continues_from_latest(fitted, model_dir, cli_run, tmp_path):
    """--resume restores the latest slot exactly; the CLI run, resumed from
    the same slot, trained on from there."""
    t, _ = fitted
    run = _copy_run(fitted, tmp_path)
    steps_per_epoch = -(-len(t.tr_idx) // 16)
    r = port.ForensicTrainer(_port_cfg(run, model_dir, batch_size=16, epochs=2, resume=True),
                             device="cpu")
    assert r.cfg.fused_adamw is True  # adopted from the slot
    assert r.start_epoch == 2 and r.state.step == steps_per_epoch
    assert r.state.opt_state["count"] == steps_per_epoch
    for part, mod in t.state.params.items():
        for (n, a), b in zip(mod.state_dict().items(), r.state.params[part].state_dict().values()):
            assert torch.equal(a, b), (part, n)
    assert torch.equal(r.state.gen.get_state(), t.state.gen.get_state())
    proc, cli_out, _ = cli_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert [json.loads(ln)["epoch"] for ln in
            (cli_out / "metrics.jsonl").read_text().splitlines()] == [1, 2]
    latest = torch.load(cli_out / "latest" / "state.pt", weights_only=True)
    assert int(latest["step"]) == int(latest["opt_state"]["count"]) == 2 * steps_per_epoch


def test_eval_only_restores_best(fitted, model_dir, tmp_path):
    run = _copy_run(fitted, tmp_path)
    e = port.ForensicTrainer(
        _port_cfg(run, model_dir, eval_only=True, train_text_tower=False, text_tower_depth=2),
        device="cpu")
    assert e.cfg.train_text_tower is True and e.cfg.text_tower_depth == 1  # adopted
    best = torch.load(run / "best" / "state.pt", weights_only=True)
    res = e.test()
    assert set(res) == TEST_KEYS
    # test() scored the best slot, not the fresh (unpretrained) params
    live = e.state.params["clf"].state_dict()
    assert not all(torch.equal(live[k], v) for k, v in best["params"]["clf"].items())


def test_foreign_trainer_tag_is_refused(fitted, model_dir, tmp_path, capsys):
    run = _copy_run(fitted, tmp_path)
    for slot in ("best", "latest"):
        meta = json.loads((run / slot / "meta.json").read_text())
        meta["trainer"] = "integrated"
        (run / slot / "meta.json").write_text(json.dumps(meta))
    capsys.readouterr()
    f = port.ForensicTrainer(_port_cfg(run, model_dir, batch_size=16, epochs=3, resume=True),
                             device="cpu")
    assert f.start_epoch == 1 and f.state.step == 0
    f.test()
    said = capsys.readouterr().out
    assert "written by the 'integrated' trainer" in said and "testing current params" in said


def test_exported_model_serves(fitted, model_dir, tmp_path):
    """export_trained of the best slot is served by the port's Predictor."""
    from ultrafnd_git_tpu_torch.predict import load_records
    from ultrafnd_git_tpu_torch.serving import Predictor
    from ultrafnd_git_tpu_torch.utils.transfer import export_trained

    served = export_trained(str(fitted[1]), "best", str(tmp_path / "served"), model_dir)
    meta = json.loads((served / "meta.json").read_text())
    assert meta["text_tower"]["depth"] == 1 and meta["text_tower"]["heads"] == 4
    assert meta["align"] == json.loads((Path(model_dir) / "meta.json").read_text())["align"]
    records = load_records(FIXTURE)
    pred = Predictor(str(served), device="cpu")
    try:
        rows = pred.predict(records)
    finally:
        pred.close()
    p = np.array([r["prob_fake"] for r in rows])
    assert len(rows) == 64 and np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()


def test_train_cli_loads_no_jax(cli_run):
    """A fresh process trains, tests and exports with the CLI on the CPU
    (`cli_run`), then finds that no jax module was loaded."""
    proc, _, exported = cli_run
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout and "==== Final Results ====" in proc.stdout
    assert (exported / "weights.pt").exists()


def test_cuda_without_gpu_raises(model_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port.ForensicTrainer(_port_cfg(tmp_path, model_dir))  # device="cuda" default
    from ultrafnd_git_tpu_torch.train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model_dir", model_dir, "--out_dir", str(tmp_path / "o")])


@pytest.mark.parametrize("flag", [
    {"dp": 2}, {"tp": 2}, {"sp": 2}, {"pp": 2},
    {"moe_experts": 4}, {"remat_tower": True},
    {"debug_nans": True}, {"save_every_steps": 5}, {"profile_dir": "p"},
], ids=lambda f: next(iter(f)))
def test_unported_flags_raise(model_dir, tmp_path, flag):
    """Every flag this test once listed as unported is ported. dp, tp, sp
    and pp ask for a mesh of two ranks, which one process refuses (with the
    launch hint, or for tp and sp alone with JAX's inference error: one
    rank does not divide; pp first meets JAX's check of this depth-1
    tower); the multi-rank runs are test_torch_trainer_mesh.py's and
    test_torch_trainer_sp_pp.py's. The single-device flags (MoE, remat,
    mid-epoch slots, debug_nans, profile_dir) build a trainer."""
    cfg = _port_cfg(tmp_path, model_dir, **flag)
    if next(iter(flag)) in ("dp", "tp", "sp", "pp"):
        with pytest.raises(ValueError, match="has 2 ranks but|not divisible by tp|"
                                             "tower depth 1 not divisible by pp=2"):
            port.ForensicTrainer(cfg, device="cpu")
    else:
        t = port.ForensicTrainer(cfg, device="cpu")
        assert getattr(t.cfg, next(iter(flag))) == flag[next(iter(flag))]


def test_cache_from_raw_data_root_builds(fixture_data_root, tmp_path, capsys):
    """The last rung of the cache ladder: with no cache in out_dir and no
    model_dir, the trainer builds one from the raw data root under its
    salt, keeps the align MLP in the run, and feeds the cache's evidence to
    the gates under use_evidence; a second run reuses both."""
    from ultrafnd_git_tpu_torch.data import cache as port_cache
    from ultrafnd_git_tpu_torch.ops import hashing

    cfg = port.TrainConfig(data_root=fixture_data_root, out_dir=str(tmp_path / "run"), seed=3,
                           hash_salt="s2", use_evidence=True, batch_size=8)
    try:
        t = port.ForensicTrainer(cfg, device="cpu")
        assert hashing.get_hash_salt() == "s2"
        assert t.cache_source == "data_root" and t.n_total == 64
        assert "feature cache: built from" in capsys.readouterr().out
        fp = json.loads(np.load(tmp_path / "run" / "feature_cache.npz")["fingerprint"].item())
        assert fp["hash_salt"] == "s2" and fp["seed"] == 3 and fp["align_init"] == "torch"
        np.testing.assert_array_equal(t.corpus["evidence"].numpy(), t.cache["evidence"])
        assert port_cache.load_align(str(tmp_path / "run"))["in_dim"] == 768
        again = port.ForensicTrainer(port.TrainConfig(**{**asdict(cfg), "use_evidence": False}),
                                     device="cpu")
        assert again.cache_source == "out_dir" and "evidence" not in again.corpus
        np.testing.assert_array_equal(again.cache["text"], t.cache["text"])
    finally:
        hashing.set_hash_salt("")
    with pytest.raises(FileNotFoundError, match="data_complete.json not found"):
        port.ForensicTrainer(port.TrainConfig(data_root=str(tmp_path / "nowhere"),
                                              out_dir=str(tmp_path / "o2")), device="cpu")
