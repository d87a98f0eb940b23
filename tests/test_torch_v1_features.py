"""PyTorch port, the v1 pipeline's feature stage and CLI
(`training/pipeline_v1.py`) against the JAX package's, on the CPU. (The
ensemble: tests/test_torch_pipeline_v1.py.)

* `BatchFeatureExtractor` on a fixture batch (two records with video,
  their first 8 frames), with the JAX align MLP carried across
  (`utils/transfer.align_state_dict`): on the host cv2 ladder the text,
  audio and visual columns equal JAX's; on the device CV stage
  (`ULTRAFND_DEVICE_CV=1`: torch on the CPU against the JAX stage) text and
  audio equal and visual within 1e-5 (the stage's flow_feat bound,
  tests/test_torch_device_cv.py); on both the align-derived temporal, aux
  and evidence within 1e-5 (the cache build's bound). `stream` yields the
  same features in order.
* The CLI trains on a root of the fixture's records with video, `--cpu`,
  in a fresh process that loads no module of jax or of the JAX package,
  and returns JAX's result keys.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from ultrafnd_git_tpu.ops import hashing as jax_hashing
from ultrafnd_git_tpu.training import pipeline_v1 as jax_v1
from ultrafnd_git_tpu_torch.data import media as port_media
from ultrafnd_git_tpu_torch.models.temporal import TemporalSyncNet
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.training import pipeline_v1 as port_v1
from ultrafnd_git_tpu_torch.utils.transfer import align_state_dict

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "tests" / "fixtures" / "fakesv_tiny"
ALIGN_ATOL = 1e-5
STAGE_ATOL = 1e-5
FRAMES = 8


@pytest.fixture(autouse=True)
def _same_salts():
    """Strings hash under each package's process-wide salt, which a module run
    before this one in the same process may have left set in only one of them:
    give both the unsalted basis for each test, then put back what was there."""
    prev = port_hashing.get_hash_salt(), jax_hashing.get_hash_salt()
    port_hashing.set_hash_salt("")
    jax_hashing.set_hash_salt("")
    yield
    port_hashing.set_hash_salt(prev[0])
    jax_hashing.set_hash_salt(prev[1])


@pytest.fixture(scope="module")
def fixture_batch():
    ds = port_media.RawMediaDataset(str(TINY), filter_existing=True)
    batch = port_media.multimodal_collate([ds[0], ds[5]])
    batch["video_frames"] = batch["video_frames"][:, :FRAMES]
    return batch


@pytest.mark.parametrize("stage", [False, True], ids=["host_ladder", "device_stage"])
def test_extractor_matches_jax(fixture_batch, monkeypatch, stage):
    monkeypatch.setenv("ULTRAFND_DEVICE_CV", "1" if stage else "0")
    jext = jax_v1.BatchFeatureExtractor(seed=0)
    pext = port_v1.BatchFeatureExtractor(seed=0, device="cpu")
    pext.tsync = TemporalSyncNet(state_dict=align_state_dict(jax.device_get(jext.tsync.params)),
                                 device="cpu")
    assert (jext._device_cv is None) == (pext._device_cv is None) == (not stage)
    ref, got = jext(fixture_batch), pext(fixture_batch)
    assert got.keys() == ref.keys()
    for k in ("text", "audio") + (() if stage else ("visual",)):
        assert np.array_equal(got[k], ref[k]), k
    if stage:
        np.testing.assert_allclose(got["visual"], ref["visual"], atol=STAGE_ATOL, rtol=0)
    for k in ("temporal", "aux", "evidence"):
        np.testing.assert_allclose(got[k], ref[k], atol=ALIGN_ATOL, rtol=0, err_msg=k)
    assert got["evidence"][:, 2].max() > 0  # the tamper cue carries signal
    streamed = list(pext.stream([(fixture_batch, "a"), (fixture_batch, "b")]))
    assert [m for _, _, m in streamed] == ["a", "b"]
    for feats, _, _ in streamed:
        for k in got:
            np.testing.assert_array_equal(feats[k], got[k])
    pext.close()


def test_cli_trains_on_fixture_without_jax(tmp_path):
    """main() on a root of the fixture's 8 records with video, then in dummy
    mode (--debug), in a fresh process: one epoch and its evaluation each;
    nothing of jax is loaded."""
    have = {v.stem for v in (TINY / "videos").iterdir()}
    lines = [ln for ln in (TINY / "data_complete.json").read_text(encoding="utf-8").splitlines()
             if json.loads(ln)["video_id"] in have][:8]
    root = tmp_path / "root"
    root.mkdir()
    (root / "data_complete.json").write_text("\n".join(lines), encoding="utf-8")
    for d in ("videos", "video_comment"):
        (root / d).symlink_to(TINY / d)
    code = f"""
import json, sys
from ultrafnd_git_tpu_torch.training import pipeline_v1
res = pipeline_v1.main(["--data_dir", {str(root)!r}, "--epochs", "1", "--batch_size", "4",
                        "--eval_every", "1", "--cpu"])
dummy = pipeline_v1.main(["--debug", "--epochs", "1", "--cpu"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                              "ultrafnd_git_tpu"))
print(json.dumps({{"results": res, "dummy": dummy, "loaded": loaded}}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    res, dummy = out["results"], out["dummy"]
    keys = ["val_acc", "val_auc", "best_val_acc", "best_val_auc", "loss", "ensemble_size",
            "steps"]  # JAX's train_and_evaluate keys, in its order
    assert list(res) == list(dummy) == keys
    assert res["steps"] == 1 and np.isfinite(res["loss"])  # 6 train rows: one batch of 4
    assert dummy["steps"] == 6 and np.isfinite(dummy["loss"])  # 32 dummy rows, batch 4
    assert "decode_failures: 0" in proc.stdout and "==== v1 Final Results ====" in proc.stdout
