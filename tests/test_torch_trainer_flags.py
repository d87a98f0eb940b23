"""PyTorch port, the trainer's last single-device flags on the CPU.

`profile_dir` writes a torch.profiler trace of `fit()` (Chrome trace
format); `debug_nans` raises FloatingPointError on a run whose training
rows hold a NaN feature and not on a clean run (without the flag the
poisoned run trains on, with NaN losses); a trainer with every
single-device flag on (MoE with 8 experts, remat, mid-epoch slots, a
profile, debug_nans) constructs and trains; `_unsupported` names only the
multi-device flags, and each of them raises; the CLI's --help lists the
seven flags that train the MoE tower, remat, mid-epoch slots, the
profile, the NaN checks and the salt search.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_moe import one_torch_thread, small_cache  # noqa: F401 (autouse fixture)
from ultrafnd_git_tpu_torch.training import trainer as port

REPO = Path(__file__).resolve().parents[1]
PARALLEL = {"dp": 2, "tp": 2, "dcn": 2, "sp": 2, "pp": 2, "shard_corpus": True,
            "shard_graph": True}


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Delete the test's run directories when it ends: one checkpoint's state.pt is
    ~150 MB, and what the tests leave behind would otherwise fill the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(tmp_path, **kw):
    base = dict(out_dir=str(tmp_path / "out"), cache_to_disk=False, batch_size=8, epochs=1,
                seed=0, log_metrics_jsonl=False)
    base.update(kw)
    return port.TrainConfig(**base)


def test_profile_dir_writes_a_trace_of_fit(tmp_path):
    prof = tmp_path / "prof"
    t = port.ForensicTrainer(_cfg(tmp_path, profile_dir=str(prof)), cache=small_cache(),
                             device="cpu")
    t.fit()
    trace = json.loads((prof / "fit.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert "aten::addmm" in names or "aten::linear" in names


def _poisoned():
    cache = small_cache()
    row = int(cache["split"][0][0])  # a training row: the first epoch reaches it
    cache["audio"] = cache["audio"].copy()
    cache["audio"][row, 3] = np.nan
    return cache


def test_debug_nans_raises_on_a_nan_feature_row(tmp_path):
    t = port.ForensicTrainer(_cfg(tmp_path, debug_nans=True), cache=_poisoned(), device="cpu")
    with pytest.raises(FloatingPointError, match="debug_nans"):
        t.fit()


def test_without_debug_nans_the_poisoned_run_trains_on(tmp_path):
    t = port.ForensicTrainer(_cfg(tmp_path), cache=_poisoned(), device="cpu")
    t.fit()
    assert t.state.step > 0


def test_debug_nans_passes_a_clean_run(tmp_path):
    t = port.ForensicTrainer(_cfg(tmp_path, debug_nans=True, train_text_tower=True,
                                  text_tower_depth=1, text_tower_heads=4, moe_experts=4),
                             cache=small_cache(), device="cpu")
    assert np.isfinite(t.fit())
    assert np.isfinite(t.test()["test_loss"])


def test_every_single_device_flag_at_once_trains(tmp_path):
    cfg = _cfg(tmp_path, train_text_tower=True, text_tower_depth=2, text_tower_heads=4,
               moe_experts=8, remat_tower=True, save_every_steps=3,
               profile_dir=str(tmp_path / "prof"), debug_nans=True, cache_to_disk=True)
    assert port._unsupported(cfg) == []
    t = port.ForensicTrainer(cfg, cache=small_cache(), device="cpu")
    tower = t.state.params["text_tower"]
    assert tower.remat and tower.blocks[0].moe.w_in.shape == (8, 64, 256)
    assert np.isfinite(t.fit())
    meta = json.loads((tmp_path / "out" / "latest" / "meta.json").read_text())
    assert meta["model"]["text_tower"]["moe_experts"] == 8
    assert meta["model"]["text_tower"]["moe_capacity_factor"] == 1.25
    assert (tmp_path / "prof" / "fit.trace.json").exists()


@pytest.mark.parametrize("flag", sorted(PARALLEL))
def test_only_the_multi_device_flags_are_unsupported(tmp_path, flag):
    cfg = _cfg(tmp_path, **{flag: PARALLEL[flag]})
    assert port._unsupported(cfg) == [flag]
    with pytest.raises(NotImplementedError, match=flag):
        port.ForensicTrainer(cfg, cache=small_cache(), device="cpu")


def test_cli_help_lists_the_new_flags():
    out = subprocess.run([sys.executable, "-m", "ultrafnd_git_tpu_torch.train", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120, check=True).stdout
    for flag in ("--moe_experts", "--moe_aux_weight", "--remat_tower", "--save_every_steps",
                 "--profile_dir", "--debug_nans", "--auto_salt"):
        assert flag in out, flag
