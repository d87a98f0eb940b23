"""PyTorch port, `training/salt_search.py` and the CLI's `--auto_salt`,
against the JAX package's salt search on the CPU.

`_tag` and `parse_salt_list` equal the JAX functions on the same inputs.
The CLI's `--auto_salt a` on the fixture data root (no tower, one epoch)
trains the unsalted and the "a" candidates, adopts the winner's best and
latest slots, feature cache, metrics log and align weights, and writes
`salt_search.json` in the JAX layout; its out_dir, exported, predicts new
records exactly as the export of a direct `--hash_salt <winner>` run does
(the same seed and salt give the same bits on the CPU). The search leaves
the winner's salt live.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from test_torch_moe import one_torch_thread  # noqa: F401 (autouse fixture)
from ultrafnd_git_tpu.ops import hashing as jax_hashing
from ultrafnd_git_tpu.training import salt_search as jax_search
from ultrafnd_git_tpu_torch.ops import hashing as port_hashing
from ultrafnd_git_tpu_torch.training import salt_search

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "fakesv_tiny"
CLI = ["--data_root", str(FIXTURE), "--epochs", "1", "--batch_size", "8", "--seed", "0",
       "--device", "cpu"]


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """Delete the test's run directories when it ends: one checkpoint's state.pt is
    ~150 MB, and what the tests leave behind would otherwise fill the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _keep_salts():
    prev = port_hashing.get_hash_salt(), jax_hashing.get_hash_salt()
    yield
    port_hashing.set_hash_salt(prev[0])
    jax_hashing.set_hash_salt(prev[1])


@pytest.mark.parametrize("salt", ["", "a", "s1", "a.b", "a_b", "x y/z", "漢字", "-_-"])
def test_tag_matches_jax(salt):
    assert salt_search._tag(salt) == jax_search._tag(salt)


@pytest.mark.parametrize("spec", [None, "", "a", "a,b,c", " a , ,b,", ",,", "s1,s1"])
def test_parse_salt_list_matches_jax(spec):
    assert salt_search.parse_salt_list(spec) == jax_search.parse_salt_list(spec)


class _ScoredTrainer:
    """A trainer stand-in whose fit() returns a fixed score per salt."""

    SCORES = {"": 0.61, "s1": 0.74, "a.b": 0.70}

    def __init__(self, cfg, **_):
        self.cfg = cfg

    def fit(self):
        return self.SCORES[self.cfg.hash_salt]


def test_search_record_and_winner_match_jax(tmp_path):
    from ultrafnd_git_tpu.training.trainer import TrainConfig as JaxConfig
    from ultrafnd_git_tpu_torch.training.trainer import TrainConfig

    got = {}
    for name, search, cfg in (
        ("jax", jax_search.search_hash_salt, JaxConfig(data_root="unused",
                                                       out_dir=str(tmp_path / "jax"))),
        ("port", salt_search.search_hash_salt, TrainConfig(out_dir=str(tmp_path / "port"))),
    ):
        Path(cfg.out_dir).mkdir()  # the CLIs make out_dir before the search
        winner, scores = search(cfg, ["s1", "a.b", "s1"], trainer_cls=_ScoredTrainer)
        got[name] = (winner, scores, json.loads(Path(cfg.out_dir, "salt_search.json").read_text()))
    assert got["port"] == got["jax"]
    assert got["port"][0] == "s1" and port_hashing.get_hash_salt() == "s1"


def test_auto_salt_adopts_the_winner_and_serves_as_a_direct_run(tmp_path, capsys):
    from ultrafnd_git_tpu_torch.predict import load_records
    from ultrafnd_git_tpu_torch.serving import Predictor
    from ultrafnd_git_tpu_torch.train import main

    out, served = tmp_path / "search", tmp_path / "search_model"
    main(CLI + ["--out_dir", str(out), "--auto_salt", "a", "--export_model_dir", str(served)])
    said = capsys.readouterr().out
    record = json.loads((out / "salt_search.json").read_text())
    assert record["candidates"] == ["", "a"]
    assert record["run_dirs"] == {"": "unsalted", "a": "salt_a"}
    winner = record["winner"]
    assert record["val_scores"][winner] == max(record["val_scores"].values())
    assert f"Selected hash_salt: {winner!r}" in said
    assert port_hashing.get_hash_salt() == winner
    run = out / "salt_search" / salt_search._tag(winner)
    for name in ("feature_cache.npz", "metrics.jsonl", "align.pt"):
        assert (out / name).read_bytes() == (run / name).read_bytes(), name
    for slot in ("best", "latest"):
        assert (out / slot / "state.pt").read_bytes() == (run / slot / "state.pt").read_bytes()
        assert json.loads((out / slot / "meta.json").read_text())["cfg"]["hash_salt"] == winner

    direct, direct_served = tmp_path / "direct", tmp_path / "direct_model"
    main(CLI + ["--out_dir", str(direct), "--hash_salt", winner,
                "--export_model_dir", str(direct_served)])
    records = load_records(str(FIXTURE / "data_complete.json"))[:12]
    rows = [Predictor(str(d), device="cpu").predict(records) for d in (served, direct_served)]
    np.testing.assert_array_equal([r["prob_fake"] for r in rows[0]],
                                  [r["prob_fake"] for r in rows[1]])
    assert json.loads((served / "meta.json").read_text())["cfg"]["hash_salt"] == winner


@pytest.mark.parametrize("flags", [["--resume"], ["--eval_only"], ["--model_dir", "x"]])
def test_auto_salt_refuses_what_it_cannot_search(tmp_path, flags):
    from ultrafnd_git_tpu_torch.train import main

    with pytest.raises(SystemExit, match="--auto_salt"):
        main(CLI + ["--out_dir", str(tmp_path), "--auto_salt", "a", *flags])
