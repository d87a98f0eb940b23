"""PyTorch port: the FakeSV dataset reader and the stratified split against
the JAX package's (`data/dataset.py`, `data/splits.py`).

Records, labels and split indices must be equal, not close: the feature
cache's rows and its train / val / test membership follow from them.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from ultrafnd_git_tpu.data import dataset as jax_dataset
from ultrafnd_git_tpu.data import splits as jax_splits
from ultrafnd_git_tpu_torch.data import dataset as port_dataset
from ultrafnd_git_tpu_torch.data import splits as port_splits

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"


def _records():
    return [json.loads(ln) for ln in
            (FIXTURES / "fakesv_hard" / "data_complete.json").read_text("utf-8").splitlines()
            if ln.strip()][:40]


def _write(root: Path, how: str) -> Path:
    """A data root whose data_complete.json is written `how`."""
    recs = _records()
    # edge records: string comments, missing fields, a U+2028 inside a value
    recs += [{"video_id": "s1", "title": "外星 警告", "comments": "一条评论", "annotation": " 假 "},
             {"annotation": "辟谣"}, {"title": "行\u2028分隔", "annotation": "fake"}]
    root.mkdir(parents=True, exist_ok=True)
    if how == "bom_pretty_array":
        text = "\ufeff\n  " + json.dumps(recs, ensure_ascii=False, indent=2)
    elif how == "bom_jsonl_blank_lines":
        text = "\ufeff\n\n" + "\r\n".join(json.dumps(r, ensure_ascii=False) for r in recs) + "\n\n"
    else:
        text = json.dumps(recs, ensure_ascii=False)
    (root / "data_complete.json").write_text(text, encoding="utf-8")
    return root


def _assert_same_dataset(root: Path):
    ref = jax_dataset.FakeSVRawDataset(str(root))
    ours = port_dataset.FakeSVRawDataset(str(root))
    assert len(ours) == len(ref) > 0
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert ours.labels.dtype == ref.labels.dtype
    assert ours.records == ref.records
    assert [ours.get_item(i) for i in range(len(ours))] == [ref.get_item(i) for i in range(len(ref))]


@pytest.mark.parametrize("name", ["fakesv_tiny", "fakesv_hard"])
def test_fixture_datasets_match_jax(name):
    _assert_same_dataset(FIXTURES / name)


@pytest.mark.parametrize("how", ["bom_pretty_array", "bom_jsonl_blank_lines", "compact_array"])
def test_written_datasets_match_jax(tmp_path, how):
    _assert_same_dataset(_write(tmp_path / how, how))


def test_missing_data_complete_raises_as_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="data_complete.json not found"):
        jax_dataset.FakeSVRawDataset(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="data_complete.json not found"):
        port_dataset.FakeSVRawDataset(str(tmp_path))


@pytest.mark.parametrize("annotation", ["假", "fake", "辟谣", "true", "real", " 假 ", "",
                                        None, "FAKE", "未知"])
def test_label_of_matches_jax(annotation):
    rec = {} if annotation is None else {"annotation": annotation}
    assert port_dataset.label_of(rec) == jax_dataset.label_of(rec)


def _labels(kind: str) -> np.ndarray:
    rng = np.random.default_rng(123)
    return {
        "balanced_64": np.repeat([0, 1], 32),
        "skewed_640": (rng.uniform(size=640) < 0.2).astype(np.int64),
        "one_class_20": np.ones(20, np.int64),
        "three_class_31": rng.integers(0, 3, size=31),
        "n1": np.array([1]),
        "n2": np.array([0, 1]),
        "n3": np.array([1, 1, 1]),
        "n3_two_class": np.array([0, 1, 0]),
    }[kind]


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("kind", ["balanced_64", "skewed_640", "one_class_20", "three_class_31",
                                  "n1", "n2", "n3", "n3_two_class"])
def test_make_split_matches_jax(kind, seed):
    labels = _labels(kind)
    ref = jax_splits.make_split(labels, np.random.default_rng(seed))
    ours = port_splits.make_split(labels, np.random.default_rng(seed))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("frac", [0.0, 0.15, 0.7, 1.0])
def test_stratified_indices_match_jax(frac):
    labels = _labels("skewed_640")
    ref = jax_splits.stratified_indices(labels, frac, np.random.default_rng(5))
    ours = port_splits.stratified_indices(labels, frac, np.random.default_rng(5))
    np.testing.assert_array_equal(ours, ref)
