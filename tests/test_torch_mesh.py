"""PyTorch port, `parallel/mesh.py` against the JAX package's mesh
(`tests/test_mesh.py`): the mesh shapes and their errors, the
`--multihost` hook (no-op, one retry of a transient failure, the
diagnostic), and the placement helpers: the rows and columns a rank of a
gloo world keeps are the ones JAX's `put_global_batch` /
`put_epoch_batches` place on the virtual device at the same mesh
coordinates (read through `addressable_shards`), with and without dcn;
and two world-1 mesh trainers in one process sharing one set of groups.
The ranks run as processes of `tests/_torch_mesh_worker.py`."""
import shutil
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch.distributed as dist

from _torch_mesh_worker import launch, small_configs
from ultrafnd_git_tpu.parallel import mesh as jmesh
from ultrafnd_git_tpu_torch.parallel import mesh as meshlib

ROWS = 16
LAYOUTS = {  # name -> (world, make_mesh kwargs)
    "dp2_tp2": (4, dict(dp=2, tp=2)),
    "dcn2_dp2": (4, dict(dp=2, dcn=2)),
    "dp4_infer": (4, dict(tp=1)),
    "dp2": (2, dict(dp=2)),
    "one": (1, dict(dp=1)),
}


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """Each layout's placement on every rank: {layout: [rank results]}."""
    root = tmp_path_factory.mktemp("mesh")
    out = {}
    for world in (4, 2, 1):
        names = [n for n, (w, _) in LAYOUTS.items() if w == world]
        cases = [{"kind": "placement", "name": n, "mesh": LAYOUTS[n][1], "rows": ROWS}
                 for n in names]
        if world == 1:
            cases.append({"kind": "two_trainers", "name": "two_trainers", "cfg": dict(
                batch_size=8, epochs=1, seed=0, cache_to_disk=False, log_metrics_jsonl=False,
                dp=1, mesh_backend="cpu", out_dir=str(root / "two_trainers"),
                **small_configs(root / "cfg"))})
            names.append("two_trainers")
        ranks = launch(cases, world, root / f"w{world}")
        for n in names:
            out[n] = [r[n] for r in ranks]
    yield out
    shutil.rmtree(root, ignore_errors=True)


def test_mesh_shape_layouts():
    assert meshlib.mesh_shape(8, dp=4, tp=2) == {"data": 4, "model": 2}
    shape = meshlib.mesh_shape(8, dp=2, tp=2, dcn=2)
    assert tuple(shape) == ("dcn", "data", "model") and shape == {"dcn": 2, "data": 2, "model": 2}
    # dp inference accounts for the dcn factor: 8 // (tp=1 * dcn=2) = 4
    assert meshlib.mesh_shape(8, dcn=2) == {"dcn": 2, "data": 4, "model": 1}
    assert meshlib.mesh_shape(8, tp=2) == {"data": 4, "model": 2}
    for kw in (dict(dp=4, tp=2), dict(dp=2, tp=2, dcn=2), dict(dcn=2), dict(tp=2)):
        jm = jmesh.make_mesh(devices=jax.devices("cpu"), **kw)
        assert meshlib.mesh_shape(8, **kw) == dict(jm.shape), kw


def test_mesh_shape_error_is_jaxs():
    with pytest.raises(ValueError, match="not divisible by tp\\*extra\\*dcn=3"):
        jmesh.make_mesh(tp=3, devices=jax.devices("cpu"))
    with pytest.raises(ValueError, match="not divisible by tp\\*extra\\*dcn=3"):
        meshlib.mesh_shape(8, tp=3)


def test_maybe_initialize_distributed_noop(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert meshlib.maybe_initialize_distributed() is False
    assert meshlib.maybe_initialize_distributed(
        coordinator="localhost:1234", num_processes=1, process_id=0) is False
    assert not dist.is_initialized()


def test_multihost_init_retries_transient_then_diagnoses(monkeypatch, capsys):
    """The transport is injected, as in the JAX test (`tests/test_mesh.py:153`):
    a transient startup failure retries after a full teardown, a terminal
    one does not, and both end in the diagnostic."""
    calls, teardowns = [], []

    def fake_init(backend, **kw):
        calls.append(kw)
        raise RuntimeError("DEADLINE_EXCEEDED: Gloo context initialization timed out")

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "destroy_process_group", lambda: teardowns.append(1))
    with pytest.raises(RuntimeError, match="multi-host initialization failed") as ei:
        meshlib.maybe_initialize_distributed("localhost:1234", 2, 1, timeout_s=7, retries=2,
                                             backend="gloo")
    assert len(calls) == 3 and len(teardowns) == 3
    assert calls[0]["timeout"] == timedelta(seconds=7)
    assert calls[0]["init_method"] == "tcp://localhost:1234"
    assert (calls[0]["world_size"], calls[0]["rank"]) == (2, 1)
    msg = str(ei.value)
    for text in ("localhost:1234", "process 1 of 2", "ULTRAFND_DIST_INIT_TIMEOUT_S", "transient"):
        assert text in msg
    out = capsys.readouterr().out
    assert "retry 1/2" in out and "retry 2/2" in out

    calls.clear()

    def fake_init_terminal(backend, **kw):
        calls.append(kw)
        raise RuntimeError("INVALID_ARGUMENT: something structural")

    monkeypatch.setattr(dist, "init_process_group", fake_init_terminal)
    with pytest.raises(RuntimeError, match="terminal"):
        meshlib.maybe_initialize_distributed("localhost:1234", 2, 0, timeout_s=7, retries=2,
                                             backend="gloo")
    assert len(calls) == 1


def _jax_cols(sharded, mesh, coords):
    """The data JAX places on the device at `coords` of `mesh`."""
    names = mesh.axis_names
    dev = np.asarray(mesh.devices)[tuple(coords[a] for a in names)]
    (shard,) = [s for s in sharded.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


@pytest.mark.parametrize("layout", ["dp2_tp2", "dcn2_dp2", "dp4_infer", "dp2", "one"])
def test_rank_rows_are_jaxs(placed, layout):
    world, kw = LAYOUTS[layout]
    jm = jmesh.make_mesh(devices=jax.devices("cpu")[:world], **kw)
    arr = np.arange(ROWS, dtype=np.int32)
    chunks = np.arange(3 * ROWS, dtype=np.int32).reshape(3, -1)
    masks = (chunks % 3 != 0).astype(np.float32)
    j_rows = jmesh.put_global_batch(arr, jm)
    j_chunks, j_masks = jmesh.put_epoch_batches(chunks, masks, jm)
    seen = set()
    for rank, res in enumerate(placed[layout]):
        assert res["shape"] == dict(jm.shape) and tuple(res["shape"]) == jm.axis_names
        assert not res["modules"]  # the ranks load no jax
        np.testing.assert_array_equal(res["rows"], _jax_cols(j_rows, jm, res["coords"]))
        np.testing.assert_array_equal(res["chunks"], _jax_cols(j_chunks, jm, res["coords"]))
        np.testing.assert_array_equal(res["masks"], _jax_cols(j_masks, jm, res["coords"]))
        seen.add(tuple(res["coords"].values()))
    assert len(seen) == world  # every coordinate of the grid has its rank


def test_a_second_mesh_trainer_takes_the_first_ones_groups(placed):
    """Two world-1 mesh trainers in one process: the second takes the
    local group and the axis groups the first made (none are leaked) and
    trains what the first trained."""
    (res,) = placed["two_trainers"]
    assert res["groups"][0] == res["groups"][1] and res["backends"] == ["gloo", "gloo"]
    assert res["losses"][0] == res["losses"][1]


def test_local_rows_refuse_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide evenly over 4"):
        meshlib._local_rows(np.arange(10), 0, 4)


@pytest.mark.parametrize("n,multiple", [(0, 4), (5, 4), (8, 4), (7, 3)])
def test_pad_to_multiple_is_jaxs(n, multiple):
    idx = np.arange(n, dtype=np.int32) * 3
    np.testing.assert_array_equal(meshlib.pad_to_multiple(idx, multiple),
                                  np.asarray(jmesh.pad_to_multiple(idx, multiple)))


def test_split_rule_is_jaxs():
    """The port's split of the fusion / classifier parameters is JAX's
    `_spec_for_path` on the same leaves (a torch weight is the JAX kernel
    transposed)."""
    leaves = {("fusion", "fuse_mlp.0.weight"): ("fusion/fuse0/kernel", 2),
              ("fusion", "fuse_mlp.0.bias"): ("fusion/fuse0/bias", 1),
              ("fusion", "fuse_mlp.3.weight"): ("fusion/fuse1/kernel", 2),
              ("fusion", "fuse_mlp.3.bias"): ("fusion/fuse1/bias", 1),
              ("clf", "pre.0.weight"): ("clf/pre0/kernel", 2),
              ("clf", "pre.0.bias"): ("clf/pre0/bias", 1),
              ("clf", "pre.3.weight"): ("clf/pre1/kernel", 2),
              ("clf", "pre.3.bias"): ("clf/pre1/bias", 1),
              ("fusion", "text_proj.weight"): ("fusion/text_proj/kernel", 2),
              ("clf", "bypass.weight"): ("clf/bypass/kernel", 2)}
    for (part, name), (path, ndim) in leaves.items():
        spec = tuple(jmesh._spec_for_path(path, np.zeros((4,) * ndim)))
        dim = meshlib.split_dim(part, name)
        if "model" not in spec:
            assert dim is None, name
        else:  # JAX's kernel axis a is the torch weight's axis ndim - 1 - a
            assert dim == (ndim - 1 - spec.index("model") if ndim == 2 else 0), name
