"""PyTorch port, the v2 trainer on a mesh of gloo ranks on the CPU
(`mesh_backend="cpu"`; the ranks are processes of
`tests/_torch_mesh_worker.py`), at small widths, against the port's
one-device trainer on the same seeded cache and config:

* {dp=2}, {tp=2}, {dp=2, tp=2}, {dcn=2, dp=2}, and a text tower with a
  switch-MoE body, grad_accum 2 and remat under {dp=2, tp=2} with the
  corpus and graph split: the val loss before training within 1e-5 and
  its AUC within 1e-6 (JAX's bound between its layouts is 1e-4,
  `tests/test_trainer_parallel.py:95`, `:129`), then two training steps
  with dropout on: the losses, the val loss after them and every
  parameter within 1e-5;
* the replicated parameters bit-identical across ranks (a tp shard across
  the ranks that hold it);
* `shard_corpus` + `shard_graph`, dense and `sparse_graph`, agreeing with
  replication within 1e-5, a rank holding N / dp rows of the graph;
* the JAX trainer on the same {dp=2} layout (a mesh of the conftest's
  virtual CPU devices), the port's ranks carrying its params: the val
  loss within 1e-4 and the AUC within 1e-6;
* `--bf16` under {dp=2} within the bf16 envelope (2e-2);
* a {tp=2} run of one epoch, resumed to two (its one-device slot cut back
  to each rank's shards), bit-identical to two unbroken epochs;
* the errors: `--dcn` with `--sp`, a batch that dp does not divide, a
  world that does not match the mesh.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_mesh_worker import collect, mesh_cache, run_trainer_case, small_configs, start
from ultrafnd_git_tpu_torch.parallel.mesh import split_dim
from ultrafnd_git_tpu_torch.utils.transfer import port_state_dicts

STEPS = 2
TOL = 1e-5
MESH_KEYS = ("dp", "tp", "dcn", "shard_corpus", "shard_graph", "mesh_backend")
TOWER = dict(train_text_tower=True, text_tower_depth=1, text_tower_heads=4)
LAYOUTS = {  # name -> (world, fields)
    "dp2": (2, {"dp": 2}),
    "tp2": (2, {"tp": 2}),
    "dp2_shard": (2, {"dp": 2, "shard_corpus": True, "shard_graph": True}),
    "dp2_sparse": (2, {"dp": 2, "sparse_graph": True}),
    "dp2_sparse_shard": (2, {"dp": 2, "sparse_graph": True, "shard_corpus": True,
                             "shard_graph": True}),
    "dp2_bf16": (2, {"dp": 2, "bf16_compute": True, **TOWER}),
    "dp2_tp2": (4, {"dp": 2, "tp": 2}),
    "dcn2_dp2": (4, {"dcn": 2, "dp": 2}),
    "tower_moe": (4, {"dp": 2, "tp": 2, "shard_corpus": True, "shard_graph": True,
                      "moe_experts": 4, "grad_accum": 2, "remat_tower": True, **TOWER}),
}
ERRORS = {  # name -> (fields, expected text)
    "dcn_with_sp": ({"dcn": 2, "sp": 2, **TOWER}, "--dcn composes with --dp/--tp only"),
    "batch_not_divided": ({"dp": 2, "batch_size": 7}, "batch_size 7 does not divide over the 2"),
    "world_not_the_mesh": ({"dp": 4}, "has 4 ranks but the process group's world has 2"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: [rank results]} of the mesh runs, {config: result} of the
    one-device runs, and the JAX trainer's val loss and metrics."""
    root = tmp_path_factory.mktemp("trainer_mesh")
    base = dict(batch_size=8, epochs=1, seed=0, cache_to_disk=False, log_metrics_jsonl=False,
                **small_configs(root / "cfg"))

    def case(name, fields, steps=STEPS, **kw):
        return {"kind": "trainer", "name": name, "steps": steps,
                "cfg": {**base, "mesh_backend": "cpu", "out_dir": str(root / name), **fields},
                **kw}

    # the JAX trainer first: its params ride with the {dp=2} ranks
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig

    jt = ForensicTrainer(TrainConfig(data_root="unused", out_dir=str(root / "jax"), dp=2,
                                     mesh_backend="cpu", **base), cache=mesh_cache())
    sds = port_state_dicts(jax.device_get(jt.state.params), None, node_tau=10.0)
    torch.save({p: {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
                for p, sd in sds.items()}, root / "jax_params.pt")
    by_world = {w: [case(n, f) for n, (ww, f) in LAYOUTS.items() if ww == w] for w in (2, 4)}
    by_world[2].append(case("jax_params", {"dp": 2}, steps=0,
                            params=str(root / "jax_params.pt")))
    by_world[2] += [{"kind": "error", "name": n, "cfg": {**base, "mesh_backend": "cpu",
                                                         "out_dir": str(root / n), **f}}
                    for n, (f, _) in ERRORS.items()]
    by_world[2].append({"kind": "resume", "name": "tp2_resume",
                        "cfg": {**base, "mesh_backend": "cpu", "tp": 2,
                                "out_dir": str(root / "tp2_resume")}})
    started = {w: start(cases, w, root / f"w{w}") for w, cases in by_world.items()}
    jax_val = jt._epoch_loop(jt.va_idx, "val")
    one = {}
    for name, (_, fields) in LAYOUTS.items():
        single = {k: v for k, v in fields.items() if k not in MESH_KEYS}
        key = tuple(sorted(single.items()))
        if key not in one:
            one[key] = run_trainer_case(case(f"one_{name}", single) | {
                "cfg": {**base, "out_dir": str(root / f"one_{name}"), **single}})
    mesh = {}
    for w, s in started.items():
        for rank in collect(s):
            for name, res in rank.items():
                mesh.setdefault(name, []).append(res)
    yield mesh, one, jax_val
    shutil.rmtree(root, ignore_errors=True)


def _one(one, name):
    single = {k: v for k, v in LAYOUTS[name][1].items() if k not in MESH_KEYS}
    return one[tuple(sorted(single.items()))]


@pytest.mark.parametrize("name", [n for n in LAYOUTS if n != "dp2_bf16"])
def test_layout_trains_what_one_device_trains(runs, name):
    mesh, one, _ = runs
    ref = _one(one, name)
    for res in mesh[name]:
        assert not res["modules"]  # the ranks load no jax
        assert abs(res["val_loss"] - ref["val_loss"]) < TOL
        assert abs(res["val"]["auc"] - ref["val"]["auc"]) < 1e-6
        np.testing.assert_allclose(res["losses"], ref["losses"], atol=TOL, rtol=0)
        assert len(res["losses"]) == STEPS
        assert abs(res["after_val_loss"] - ref["after_val_loss"]) < TOL
        for part, sd in ref["params"].items():
            for key, t in sd.items():
                np.testing.assert_allclose(res["params"][part][key].numpy(), t.numpy(),
                                           atol=TOL, rtol=0, err_msg=f"{name} {part}.{key}")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_replicated_parameters_are_bit_identical_across_ranks(runs, name):
    mesh, _, _ = runs
    ranks = mesh[name]
    for res in ranks[1:]:
        same_shard = res["mesh"]["coords"]["model"] == ranks[0]["mesh"]["coords"]["model"]
        for part, sd in ranks[0]["local"].items():
            for key, t in sd.items():
                if split_dim(part, key) is None or same_shard:
                    assert torch.equal(res["local"][part][key], t), f"{name} {part}.{key}"


@pytest.mark.parametrize("split,replicated", [("dp2_shard", "dp2"),
                                              ("dp2_sparse_shard", "dp2_sparse")])
def test_split_corpus_and_graph_agree_with_replication(runs, split, replicated):
    mesh, _, _ = runs
    n = len(mesh_cache()["labels"])
    for res, rep in zip(mesh[split], mesh[replicated]):
        graph = "nbr_idx" if "sparse" in split else "a_norm"
        assert res["rows"][graph] == n // 2 and rep["rows"][graph] == n
        assert res["rows"]["audio"] == n // 2 and set(res["owned"]) == set(res["rows"]) - {"ax"}
        assert abs(res["val_loss"] - rep["val_loss"]) < TOL
        np.testing.assert_allclose(res["losses"], rep["losses"], atol=TOL, rtol=0)
        for part, sd in rep["params"].items():
            for key, t in sd.items():
                np.testing.assert_allclose(res["params"][part][key].numpy(), t.numpy(),
                                           atol=TOL, rtol=0)


def test_dp2_matches_the_jax_trainer_on_its_mesh(runs):
    mesh, _, (jax_loss, jax_metrics) = runs
    for res in mesh["jax_params"]:
        assert abs(res["val_loss"] - jax_loss) < 1e-4
        assert abs(res["val"]["auc"] - jax_metrics["auc"]) < 1e-6


def test_bf16_on_a_mesh_is_in_the_bf16_envelope(runs):
    mesh, one, _ = runs
    ref = _one(one, "dp2_bf16")
    for res in mesh["dp2_bf16"]:
        assert abs(res["val_loss"] - ref["val_loss"]) < 2e-2
        np.testing.assert_allclose(res["losses"], ref["losses"], atol=2e-2, rtol=0)


@pytest.mark.parametrize("name", list(ERRORS))
def test_mesh_errors(runs, name):
    mesh, _, _ = runs
    for res in mesh[name]:
        assert res["error"] is not None and ERRORS[name][1] in res["error"], res["error"]


def test_tp_resume_reshards_and_continues_bit_identically(runs):
    mesh, _, _ = runs
    for res in mesh["tp2_resume"]:
        assert res["same"] and res["steps"][0] == res["steps"][1] > 0
        assert res["local_shapes"]["fuse_mlp.0.weight"][0] == 64  # half of 2H = 128 rows
