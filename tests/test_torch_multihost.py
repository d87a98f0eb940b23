"""PyTorch port, the train CLI as a mesh of processes (`--multihost
--device cpu`: gloo ranks joined through JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID), on the fixture, as the JAX package's
`tests/test_multihost.py:96` and `test_multihost_cli.py` run its CLI:

* two processes at --dp 2 and at --tp 2 print identical final results,
  write one metrics.jsonl line an epoch (rank 0 alone writes), and train
  the losses a one-process run trains within 1e-4; they load no module
  of jax or of the JAX package;
* the --tp 2 run's `best` slot (its shards gathered by the writer)
  restores in a fresh single process and serves through `predict`;
* a --dp 2 run killed after its first mid-epoch slot (--save_every_steps)
  and resumed under the mesh ends bit-identical to an unbroken --dp 2 run;
* `--trainer integrated` names the mesh flags among those it ignores.
"""
import json
import os
import re
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrafnd_git_tpu_torch.predict import load_records

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny"
ARGS = ["--data_root", str(FIXTURE), "--batch_size", "8", "--seed", "0", "--device", "cpu"]
RUN = """
import os, signal, sys
os.nice(10)  # the ranks must not starve the other tests that share the machine
from ultrafnd_git_tpu_torch.train import main
from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer

if os.environ.get("KILL_AFTER_MID_EPOCH_SLOT"):
    save = ForensicTrainer._save_step_checkpoint

    def save_then_die(self, *a):
        save(self, *a)
        print("SIGKILL after the mid-epoch slot", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)

    ForensicTrainer._save_step_checkpoint = save_then_die
main(sys.argv[1:])
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "ultrafnd_git_tpu")]
print("NO_JAX_OK" if not loaded else f"LOADED {loaded[:5]}")
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(out_dir, extra, world=2, env_extra=None):
    """`world` processes of the CLI (one when world is 1, with no mesh)."""
    port = _port()
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO), ULTRAFND_DISABLE_HF="1",
                   OMP_NUM_THREADS="1", **(env_extra or {}))
        if world > 1:
            env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                       JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RUN, *ARGS, "--out_dir", str(out_dir), *extra], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, expect_rc=0):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == expect_rc, o[-3000:]
    return outs


def _metrics(out_dir):
    return [json.loads(ln) for ln in (out_dir / "metrics.jsonl").read_text().splitlines()]


def _final(out):
    return re.findall(r"Test \w+ ?:?.*", out.split("Final Results")[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    mesh = ["--multihost", "--epochs", "2", "--save_every_steps", "2"]
    dirs = {k: root / k for k in ("one", "dp", "tp", "killed")}
    started = {
        "one": _spawn(dirs["one"], ["--epochs", "2"], world=1),
        "dp": _spawn(dirs["dp"], [*mesh, "--dp", "2", "--shard_graph"]),
        "tp": _spawn(dirs["tp"], [*mesh, "--tp", "2", "--shard_corpus"]),
        "killed": _spawn(dirs["killed"], [*mesh, "--dp", "2", "--shard_graph"],
                         env_extra={"KILL_AFTER_MID_EPOCH_SLOT": "1"}),
    }
    outs = {k: _wait(p, expect_rc=-9 if k == "killed" else 0) for k, p in started.items()}
    resumed = _spawn(dirs["killed"], [*mesh, "--dp", "2", "--shard_graph", "--resume"])
    served = subprocess.run(
        [sys.executable, "-m", "ultrafnd_git_tpu_torch.predict", "--out_dir", str(dirs["tp"]),
         "--checkpoint", "best", "--device", "cpu", "--input",
         str(FIXTURE / "data_complete.json")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), ULTRAFND_DISABLE_HF="1"))
    outs["resumed"] = _wait(resumed)
    yield dirs, outs, served
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_two_processes_print_the_same_results_and_write_once(runs, kind):
    dirs, outs, _ = runs
    for i, out in enumerate(outs[kind]):
        assert f"multi-host: process {i} of 2" in out and "NO_JAX_OK" in out
    assert _final(outs[kind][0]) == _final(outs[kind][1]) and "Test Acc" in "".join(
        _final(outs[kind][0]))
    rows = _metrics(dirs[kind])
    assert [r["epoch"] for r in rows] == [1, 2]
    for slot in ("best", "latest"):
        assert (dirs[kind] / slot / "meta.json").exists()


@pytest.mark.parametrize("kind", ["dp", "tp"])
def test_mesh_losses_match_one_process(runs, kind):
    dirs, outs, _ = runs
    assert "NO_JAX_OK" in outs["one"][0]
    for ours, ref in zip(_metrics(dirs[kind]), _metrics(dirs["one"])):
        for key in ("train_loss", "val_loss", "val_auc"):
            assert abs(ours[key] - ref[key]) < 1e-4, (kind, key)


def test_tp_best_slot_restores_and_serves_in_one_process(runs):
    dirs, _, served = runs
    assert served.returncode == 0, served.stderr[-3000:]
    rows = [json.loads(ln) for ln in served.stdout.splitlines() if ln.startswith("{")]
    n = len(load_records(str(FIXTURE / "data_complete.json")))
    assert len(rows) == n and all(np.isfinite(r["prob_fake"]) for r in rows)
    payload = torch.load(dirs["tp"] / "best" / "state.pt", weights_only=True)
    assert payload["params"]["fusion"]["fuse_mlp.0.weight"].shape[0] == 2 * payload[
        "params"]["fusion"]["fuse_mlp.3.weight"].shape[0]  # the full (2H, 16H) layer


def test_resume_under_the_mesh_is_bit_identical(runs):
    dirs, outs, _ = runs
    assert all("SIGKILL after the mid-epoch slot" in o for o in outs["killed"])
    assert all("NO_JAX_OK" in o for o in outs["resumed"])
    a = torch.load(dirs["killed"] / "latest" / "state.pt", weights_only=True)
    b = torch.load(dirs["dp"] / "latest" / "state.pt", weights_only=True)
    for part, sd in b["params"].items():
        for key, t in sd.items():
            assert torch.equal(a["params"][part][key], t), f"{part}.{key}"
    assert torch.equal(a["rng"], b["rng"]) and int(a["step"]) == int(b["step"])
    assert _metrics(dirs["killed"])[-1] == {**_metrics(dirs["dp"])[-1],
                                            "seconds": _metrics(dirs["killed"])[-1]["seconds"]}


def test_integrated_trainer_ignores_the_mesh_flags_as_jax_does():
    """run_train_eval.py's `--trainer integrated` note names the v2-only flags
    set, the mesh flags among them, in its order."""
    from ultrafnd_git_tpu_torch.train import V2_ONLY, parse_args

    args = parse_args(["--dp", "2", "--tp", "2", "--dcn", "2", "--shard_corpus",
                       "--shard_graph", "--sp", "2", "--pp", "2", "--train_text_tower"])
    assert [flag for flag, on in V2_ONLY if on(args)] == [
        "--train_text_tower", "--dp", "--tp", "--dcn", "--shard_corpus", "--shard_graph",
        "--sp", "--pp"]
