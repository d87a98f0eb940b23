"""PyTorch port, `save_every_steps` and `--resume` from a mid-epoch slot.

(a) The mid-epoch `latest` slot's meta.json has the JAX trainer's keys
(`_save_step_checkpoint`, `trainer.py:1078-1104`: in_epoch, step_cursor,
epoch_order, np_random_state with the epoch's keys), plus the "model" entry
of module dims that every slot of the port carries; the cursor and the
order are the ones the run took.
(b) The training CLI on a small MoE tower (dropout on, 4 steps an epoch,
--save_every_steps 2, two epochs) runs three times, each in a process of
its own: uninterrupted; killed with SIGKILL right after its first
mid-epoch slot commits; and `--resume` of the killed run. The resumed
run's `latest` slot (parameters, AdamW moments and count, step, dropout
generator) equals the uninterrupted run's bit for bit. The worker is this
file run as a script:
    python tests/test_torch_resume.py MODEL_DIR OUT_DIR KILL [CLI args...]
"""
import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if __name__ != "__main__":  # the worker runs without pytest's path to the tests
    from test_torch_moe import one_torch_thread  # noqa: F401 (autouse fixture)
CLI = ["--train_text_tower", "--text_tower_depth", "2", "--text_tower_heads", "4",
       "--moe_experts", "4", "--batch_size", "8", "--epochs", "2", "--seed", "0",
       "--save_every_steps", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Delete the test's run directories when it ends: one checkpoint's state.pt is
    ~150 MB, and what the tests leave behind would otherwise fill the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _worker(model_dir: str, out_dir: str, kill: bool, extra) -> None:
    torch.set_num_threads(1)  # the same reduction order in every process
    from ultrafnd_git_tpu_torch.train import main
    from ultrafnd_git_tpu_torch.training import checkpoint as ckpt

    if kill:
        save = ckpt.save_checkpoint

        def save_then_die(directory, name, state, meta):
            save(directory, name, state, meta)
            if meta.get("in_epoch"):
                print(f"SIGKILL after the mid-epoch slot at step {meta['step_cursor']}",
                      flush=True)
                os.kill(os.getpid(), signal.SIGKILL)

        ckpt.save_checkpoint = save_then_die
    main(["--model_dir", model_dir, "--out_dir", out_dir, *CLI, *extra])


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A directory holding only a small synthetic cache (text width 64,
    16 tokens): the CLI's --model_dir."""
    from test_torch_moe import small_cache
    from ultrafnd_git_tpu_torch.data.cache import save_cache

    root = tmp_path_factory.mktemp("small_model_dir")
    save_cache(small_cache(), str(root / "feature_cache.npz"))
    return str(root)


def test_mid_epoch_slot_meta_has_the_jax_keys(model_dir, tmp_path, monkeypatch):
    from test_torch_moe import small_cache
    from ultrafnd_git_tpu.training import checkpoint as jax_ckpt
    from ultrafnd_git_tpu.training.trainer import ForensicTrainer as JaxTrainer
    from ultrafnd_git_tpu.training.trainer import TrainConfig as JaxConfig
    from ultrafnd_git_tpu_torch.training import checkpoint as ckpt
    from ultrafnd_git_tpu_torch.training import trainer as port

    jt = JaxTrainer(JaxConfig(data_root="unused", out_dir=str(tmp_path / "jax"), batch_size=8,
                              epochs=1, seed=0, save_every_steps=2, cache_to_disk=False),
                    cache=small_cache())
    jt._save_step_checkpoint(1, 2, np.asarray(jt.tr_idx, np.int32))
    jax_ckpt.wait_for_writes()
    jax_keys = set(json.loads((tmp_path / "jax" / "latest" / "meta.json").read_text()))

    metas, save = [], ckpt.save_checkpoint

    def record(directory, name, state, meta):
        metas.append((name, json.loads(json.dumps(meta))))
        save(directory, name, state, meta)

    monkeypatch.setattr(ckpt, "save_checkpoint", record)
    pt = port.ForensicTrainer(port.TrainConfig(out_dir=str(tmp_path / "port"), model_dir=model_dir,
                                               batch_size=8, epochs=1, seed=0,
                                               save_every_steps=2), device="cpu")
    orders = []
    epoch_order = pt.epoch_order
    monkeypatch.setattr(pt, "epoch_order", lambda s, t: orders.append(epoch_order(s, t)) or orders[-1])
    pt.fit()
    mid = [m for name, m in metas if m.get("in_epoch")]
    steps = -(-len(pt.tr_idx) // 8)
    assert steps == 4 and len(mid) == 1  # after step 2; none after the last step
    assert [name for name, _ in metas] == ["latest", "best", "latest"]
    assert set(mid[0]) - {"model"} == jax_keys and "model" in mid[0]
    assert mid[0]["step_cursor"] == 2 and mid[0]["epoch"] == 1
    assert mid[0]["epoch_order"] == orders[0].tolist()
    assert not metas[-1][1].get("in_epoch")  # the epoch's own slot replaces it


def _run(model_dir, out_dir, kill=False, extra=()):
    return subprocess.run([sys.executable, __file__, model_dir, str(out_dir), str(int(kill)),
                           *extra], cwd=REPO, capture_output=True, text=True, timeout=600)


def test_sigkilled_run_resumes_bit_identical(model_dir, tmp_path):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    ref = _run(model_dir, whole)
    assert ref.returncode == 0, ref.stderr[-3000:]
    killed = _run(model_dir, cut, kill=True)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-3000:]
    assert "SIGKILL after the mid-epoch slot at step 2" in killed.stdout
    meta = json.loads((cut / "latest" / "meta.json").read_text())
    assert meta["in_epoch"] and meta["epoch"] == 1 and meta["step_cursor"] == 2
    assert not (cut / "best").exists()
    resumed = _run(model_dir, cut, extra=["--resume"])
    assert resumed.returncode == 0, resumed.stderr[-3000:]

    a = torch.load(whole / "latest" / "state.pt", weights_only=True)
    b = torch.load(cut / "latest" / "state.pt", weights_only=True)
    assert int(a["step"]) == int(b["step"]) == 8
    assert torch.equal(a["rng"], b["rng"])
    assert int(a["opt_state"]["count"]) == int(b["opt_state"]["count"])
    for part, sd in a["params"].items():
        assert any("moe.w_in" in k for k in sd) or part != "text_tower"
        for k, v in sd.items():
            assert torch.equal(v, b["params"][part][k]), (part, k)
        for key in ("mu", "nu"):
            for k, v in a["opt_state"][key][part].items():
                assert torch.equal(v, b["opt_state"][key][part][k]), (key, part, k)
    ma, mb = (json.loads((d / "latest" / "meta.json").read_text()) for d in (whole, cut))
    assert ma["np_random_state"] == mb["np_random_state"]
    assert ma["best_val_auc"] == mb["best_val_auc"] and ma["epoch"] == mb["epoch"] == 2


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _worker(sys.argv[1], sys.argv[2], sys.argv[3] == "1", sys.argv[4:])
