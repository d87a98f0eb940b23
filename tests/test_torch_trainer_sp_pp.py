"""PyTorch port, the v2 trainer under --sp and --pp on meshes of gloo
ranks on the CPU (`mesh_backend="cpu"`; the ranks are processes of
`tests/_torch_mesh_worker.py`), at small widths (tower 32 wide, depth 2, 4
heads, S = 8):

* a world of 2 at {sp=2} and {pp=2, pp_microbatches=4}, a world of 4 at
  {dp=2, sp=2} and {tp=2, pp=2}, every run starting from the JAX trainer's
  initial parameters: the val loss before training within 1e-4 of the JAX
  trainer's on the same layout (a mesh of the conftest's virtual CPU
  devices), and within 1e-5 of the one-device port trainer's; then two
  training steps with dropout on against the one-device port trainer's:
  the losses, the clip's global norm of each step (a gradient summed twice
  over sp or pipe, or short of a rank's share, moves it) and every
  gathered parameter within 1e-5;
* the replicated parameters bit-identical across the ranks (a tp shard
  across the ranks that hold it);
* the training CLI's main() at --sp 2 and at --pp 2 --pp_microbatches 4
  in the world of 2 (the world's group is the mesh's), on a model
  directory holding the small synthetic cache: its metrics.jsonl within
  1e-4 of a one-process run's;
* the JAX trainer's flag errors, with its text: sp/pp without
  --train_text_tower, with --moe_experts, together, a depth pp does not
  divide, a token length sp does not divide.
"""
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_mesh_worker import collect, mesh_cache, run_trainer_case, small_configs, start
from ultrafnd_git_tpu_torch.parallel.mesh import split_dim
from ultrafnd_git_tpu_torch.utils.transfer import port_state_dicts

STEPS = 2
TOL = 1e-5
TOWER = dict(train_text_tower=True, text_tower_depth=2, text_tower_heads=4)
LAYOUTS = {  # name -> (world, fields)
    "sp2": (2, {"dp": 1, "sp": 2}),
    "pp2_mb4": (2, {"dp": 1, "pp": 2, "pp_microbatches": 4}),
    "dp2_sp2": (4, {"dp": 2, "sp": 2}),
    "tp2_pp2": (4, {"dp": 1, "tp": 2, "pp": 2}),
}
ERRORS = {  # name -> (fields, cache kwargs, world that runs it)
    "sp_without_tower": ({"sp": 2}, {}, 1),
    "pp_with_moe": ({"pp": 2, "moe_experts": 4, **TOWER}, {}, 1),
    "sp_and_pp": ({"sp": 2, "pp": 2, **TOWER}, {}, 1),
    "depth_pp": ({"pp": 2, **TOWER, "text_tower_depth": 3}, {}, 1),
    "length_sp": ({"dp": 1, "sp": 2, **TOWER}, {"seq": 7}, 2),
}
CLI = ["--batch_size", "8", "--seed", "0", "--epochs", "1", "--device", "cpu",
       "--train_text_tower", "--text_tower_depth", "2", "--text_tower_heads", "4"]
CLI_LAYOUTS = {"cli_sp2": ["--sp", "2"], "cli_pp2_mb4": ["--pp", "2", "--pp_microbatches", "4"]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side of these tests runs small tensors, which one thread
    computes faster than a pool that parallel test workers oversubscribe;
    the previous count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: [rank results]} of the mesh runs, the one-device run, the JAX
    trainer's val loss by layout, the JAX error texts and the CLI's
    one-process metrics."""
    root = tmp_path_factory.mktemp("trainer_sp_pp")
    base = dict(batch_size=8, epochs=1, seed=0, cache_to_disk=False, log_metrics_jsonl=False,
                **small_configs(root / "cfg"))
    from ultrafnd_git_tpu_torch.data.cache import save_cache

    save_cache(mesh_cache(), str(root / "model" / "feature_cache.npz"))
    cli = CLI + ["--model_dir", str(root / "model")]
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig

    jax_val, jax_params = {}, None
    for name, (_, fields) in LAYOUTS.items():
        jt = ForensicTrainer(TrainConfig(data_root="unused", out_dir=str(root / f"jax_{name}"),
                                         mesh_backend="cpu", **base, **TOWER, **fields),
                             cache=mesh_cache())
        if jax_params is None:  # the initial parameters every run carries
            sds = port_state_dicts(jax.device_get(jt.state.params), None, node_tau=10.0)
            torch.save({p: {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
                        for p, sd in sds.items()}, root / "jax_params.pt")
            jax_params = str(root / "jax_params.pt")
            by_world = {w: [] for w in (2, 4)}
            for n, (w, f) in LAYOUTS.items():
                by_world[w].append({"kind": "trainer", "name": n, "steps": STEPS,
                                    "params": jax_params, "cfg": {
                                        **base, **TOWER, **f, "mesh_backend": "cpu",
                                        "out_dir": str(root / n)}})
            by_world[2] += [{"kind": "error", "name": n, "cache": c, "cfg": {
                **base, **f, "mesh_backend": "cpu", "out_dir": str(root / n)}}
                for n, (f, c, w) in ERRORS.items() if w == 2]
            by_world[2] += [{"kind": "cli", "name": n, "argv": cli + flags + [
                "--out_dir", str(root / n)]} for n, flags in CLI_LAYOUTS.items()]
            # at full priority: their steps run many small collectives in
            # lock step, and a niced rank waiting for a core on a loaded
            # machine stalls its whole world
            started = {w: start(cases, w, root / f"w{w}", nice=0)
                       for w, cases in by_world.items()}
        jax_val[name] = jt._epoch_loop(jt.va_idx, "val")[0]
    jax_errors = {}
    for name, (fields, cache, _) in ERRORS.items():
        try:
            ForensicTrainer(TrainConfig(data_root="unused", out_dir=str(root / f"jax_{name}"),
                                        mesh_backend="cpu", **base, **fields),
                            cache=mesh_cache(**cache))
        except ValueError as exc:
            jax_errors[name] = str(exc)
    one = run_trainer_case({"kind": "trainer", "name": "one", "steps": STEPS,
                            "params": jax_params,
                            "cfg": {**base, **TOWER, "out_dir": str(root / "one")}})
    from ultrafnd_git_tpu_torch.train import main as train_main

    train_main(cli + ["--out_dir", str(root / "cli_one")])
    cli_one = _metrics(root / "cli_one")
    mesh = {}
    for s in started.values():
        for rank in collect(s, timeout=480):
            for name, res in rank.items():
                mesh.setdefault(name, []).append(res)
    yield mesh, one, jax_val, jax_errors, cli_one, root
    shutil.rmtree(root, ignore_errors=True)


def _metrics(out_dir):
    return [json.loads(ln) for ln in (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_trains_what_one_device_trains(runs, name):
    mesh, one, _, _, _, _ = runs
    for res in mesh[name]:
        assert not res["modules"]  # the ranks load no jax
        assert abs(res["val_loss"] - one["val_loss"]) < TOL
        assert len(res["losses"]) == STEPS == len(res["norms"])
        np.testing.assert_allclose(res["losses"], one["losses"], atol=TOL, rtol=0)
        np.testing.assert_allclose(res["norms"], one["norms"], atol=TOL, rtol=0)
        assert abs(res["after_val_loss"] - one["after_val_loss"]) < TOL
        for part, sd in one["params"].items():
            for key, t in sd.items():
                np.testing.assert_allclose(res["params"][part][key].numpy(), t.numpy(),
                                           atol=TOL, rtol=0, err_msg=f"{name} {part}.{key}")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_eval_loss_at_init_matches_the_jax_trainer(runs, name):
    mesh, _, jax_val, _, _, _ = runs
    for res in mesh[name]:
        assert abs(res["val_loss"] - jax_val[name]) < 1e-4


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_replicated_parameters_are_bit_identical_across_ranks(runs, name):
    mesh, _, _, _, _, _ = runs
    ranks = mesh[name]
    for res in ranks[1:]:
        same_shard = res["mesh"]["coords"]["model"] == ranks[0]["mesh"]["coords"]["model"]
        for part, sd in ranks[0]["local"].items():
            for key, t in sd.items():
                if split_dim(part, key) is None or same_shard:
                    assert torch.equal(res["local"][part][key], t), f"{name} {part}.{key}"


@pytest.mark.parametrize("name", list(CLI_LAYOUTS))
def test_cli_trains_on_the_layout_as_one_process(runs, name):
    mesh, _, _, _, cli_one, root = runs
    rows = _metrics(root / name)  # rank 0 alone writes
    assert [r["epoch"] for r in rows] == [1]
    for key in ("train_loss", "val_loss", "val_auc"):
        assert abs(rows[0][key] - cli_one[0][key]) < 1e-4, key
    results = [r["results"] for r in mesh[name]]
    assert results[0] == results[1] and "test_auc" in results[0]
    assert (root / name / "best" / "meta.json").exists()


@pytest.mark.parametrize("name", list(ERRORS))
def test_flag_errors_are_jaxs(runs, name, tmp_path):
    mesh, _, _, jax_errors, _, _ = runs
    fields, cache, world = ERRORS[name]
    if world == 1:
        from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

        with pytest.raises(ValueError) as err:
            ForensicTrainer(TrainConfig(out_dir=str(tmp_path), cache_to_disk=False, **fields),
                            cache=mesh_cache(**cache), device="cpu")
        errors = [f"ValueError: {err.value}"]
    else:
        errors = [res["error"] for res in mesh[name]]
    for e in errors:
        assert e == f"ValueError: {jax_errors[name]}"
