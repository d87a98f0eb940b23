"""The harness: data-driven cells, the contract's spec and result line, the
JAX check and the look for a card."""
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.conftest import run_tiny, tiny_bert_cell, tiny_train_cell

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"[^\n\t]{1,200}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_the_spec_has_exactly_the_contract_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_lines_use_the_allowed_characters():
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry and key != "source" or key == "source" and entry in SPEC["configs"]:
                assert LINE.match(entry[key]), entry[key]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names))
    assert all(LINE.match(word) for word in SPEC["command"])


def test_every_cell_names_files_and_readers_that_exist():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (HERE / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        names = [n for n, _ in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names and len(cell.end_to_end) >= 2 and cell.per_layer
        for name in names:
            assert callable(harness.metric_reader(name))
        for m in SPEC["per_layer"]:
            assert m["moves"] in e2e
            if w["name"] in m.get("workloads", []):
                assert m["moves"] in [n for n, _ in cell.end_to_end]
    assert {w["config"] for w in SPEC["workloads"]} == {c["name"] for c in SPEC["configs"]}


def test_a_new_cell_is_found_by_adding_files_only(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "bert_base_uncased.encode_short_s64",
                              "config": "bert_base_uncased", "traffic": "encode_short_s64",
                              "chips": 1, "why": "short strings"})
    spec["per_layer"].append({"name": "encode.strings", "unit": "strings", "better": "higher",
                              "source": "host_clock", "layer": "encoder wrapper",
                              "moves": "encode_tokens_per_s",
                              "workloads": ["bert_base_uncased.encode_short_s64"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "bert_base_uncased.encode_ocr_s256" in m.get("workloads", []):
            m["workloads"].append("bert_base_uncased.encode_short_s64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((HERE / "traffic" / "encode_ocr_s256.json").read_text())
    traffic["fields"] = [{"name": "title", "p": 1.0, "count": [256, 256], "tokens": [8, 64]}]
    (tmp_path / "portbench" / "traffic" / "encode_short_s64.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "workloads" / "bert_base_uncased.encode_short_s64.json").write_text(
        json.dumps({"rows": 1e-4}))
    (tmp_path / "portbench" / "metrics" / "encode.strings.py").write_text(
        "def read(rec):\n    return sum(u['rows'] for u in rec['units'])\n")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "c = harness.load_cell('bert_base_uncased.encode_short_s64')\n"
            "print(c.traffic['driver'], [n for n, _ in c.per_layer],"
            " harness.metric_reader('encode.strings')({'units': [{'rows': 3}]}))\n"
            % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "bert_encode" in proc.stdout and "'encode.strings'" in proc.stdout
    assert proc.stdout.strip().endswith(" 3")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("which", ["train", "bert"])
def test_the_result_line_holds_the_contract_keys(which, trace):
    cell = tiny_train_cell() if which == "train" else tiny_bert_cell()
    result = run_tiny(cell, trace=trace)["result"]
    assert RESULT_KEYS <= set(result) <= RESULT_KEYS | {"breakdown", "check"}
    assert list(result)[-1] == "check"  # the numbers compared come last
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for name, c in result["check"].items():
        assert set(c) == {"value", "limit"} and math.isfinite(c["value"])
    wanted = dict(cell.per_layer if trace else cell.end_to_end)
    assert set(result["metrics"]) <= set(wanted)
    for name, m in result["metrics"].items():
        assert m["unit"] == wanted[name] and math.isfinite(m["value"])
    if not trace:  # every end-to-end metric is read on any device
        assert set(result["metrics"]) == set(wanted)
    else:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("ultrafnd_git_tpu", True), ("ultrafnd_git_tpu.x", True),
    ("ultrafnd_git_tpu_torch", False), ("ultrafnd_git_tpu_torch.x", False),
    ("jaxtyping", False), ("numpy", False),
])
def test_the_import_check_compares_whole_top_level_names(name, bad):
    assert harness.forbidden_modules([name, "torch"]) == ([name] if bad else [])


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure it")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "fnd_tower.train_f32_b512",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr


def test_an_unknown_cell_fails():
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "no.such",
                           "--seed", "1", "--seconds", "1"], capture_output=True, text=True)
    assert proc.returncode != 0 and not proc.stdout


def test_a_nan_leaf_makes_the_median_gap_infinite():
    import torch

    from portbench import check

    ref = {k: torch.ones(3) for k in "abcde"}
    prog = dict(ref, e=torch.tensor([float("nan"), 1.0, 1.0]))
    med, worst, leaf = check.median_and_worst(check.leaf_norm_gaps(prog, ref))
    assert med == worst == math.inf and leaf == "e"
    assert check.median_and_worst(check.leaf_norm_gaps(ref, ref))[:2] == (0.0, 0.0)


def test_every_number_compared_has_its_limit_and_every_limit_its_number():
    from portbench import check

    assert check.judge({"a": 1.0}, {"a": 1.5}) == {"a": {"value": 1.0, "limit": 1.5}}
    for numbers, limits in (({"a": 1.0, "b": 2.0}, {"a": 1.5}), ({"a": 1.0}, {"a": 1.5, "c": 1.0})):
        with pytest.raises(KeyError):
            check.judge(numbers, limits)


def test_busy_time_is_the_union_of_device_intervals_and_gaps_are_named_by_the_host():
    from portbench import profiles

    ops = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 30.0, 40.0), ("k3", 70.0, 80.0)]
    rec = profiles.summarise(ops, 100e-6)
    assert rec["busy_s"] == pytest.approx(40e-6) and rec["span_s"] == pytest.approx(80e-6)
    assert rec["by_name"] == {"k1": pytest.approx(20e-6), "k2": pytest.approx(15e-6),
                              "k3": pytest.approx(10e-6)}
    assert rec["device_ops"][0] == ["k1", pytest.approx(20e-6)] and rec["launches"] == 4
    host = [(0.0, 100.0, "outer"), (21.0, 29.0, "aten::mm"), (45.0, 50.0, "aten::sum")]
    gaps = dict(profiles.idle_gaps(ops, host))
    assert gaps == {"aten::mm": pytest.approx(10e-6), "outer": pytest.approx(30e-6)}


def test_a_traced_encode_counts_only_the_window():
    out = run_tiny(tiny_bert_cell(), trace=True)
    result = out["result"]
    assert result["attempted"] >= 1 and result["correct"]
    assert 0.0 < result["metrics"]["encode.pad_share"]["value"] < 100.0
