"""`correct` comes out false when the timed path is broken underneath: the
rest of a run at a test's size on the CPU (the look for a card skipped),
once for each fault the cell can have (`faults.py`). The control (the
reference in TF32 in the program's place) needs the card:
`test_portbench_control.py`."""
import pytest

from portbench import faults
from portbench.tests.conftest import run_tiny, tiny_bert_cell, tiny_train_cell


def test_a_sound_train_step_is_correct():
    assert run_tiny(tiny_train_cell())["result"]["correct"]


def test_a_step_that_leaves_its_state_unchanged_fails():
    with faults.unchanged():
        out = run_tiny(tiny_train_cell())
    assert not out["result"]["correct"]
    assert out["checks"]["change3_median"]["value"] > 0.5


def test_a_step_over_half_its_batch_fails():
    with faults.half_batch():
        out = run_tiny(tiny_train_cell())
    assert not out["result"]["correct"]
    assert out["checks"]["loss"]["value"] > 1e-3


def test_an_attention_gradient_off_in_the_tower_alone_fails():
    """The query gradient 10% off reaches only the tower's leaves: the
    median leaf does not see it, the worst leaf does."""
    with faults.attention_grad():
        out = run_tiny(tiny_train_cell())
    assert not out["result"]["correct"]
    assert out["checks"]["grad1_worst"]["value"] > out["checks"]["grad1_worst"]["limit"]
    assert out["checks"]["grad1_median"]["value"] < out["checks"]["grad1_median"]["limit"]


def test_one_leaf_left_unmoved_by_the_optimizer_fails():
    """One leaf's update lost (its moments kept): the medians and the first
    gradient do not see it, the worst leaf's change does."""
    with faults.one_leaf_kept():
        out = run_tiny(tiny_train_cell())
    assert not out["result"]["correct"]
    assert out["checks"]["change3_worst"]["value"] > 0.5


def test_a_sound_encode_is_correct():
    assert run_tiny(tiny_bert_cell())["result"]["correct"]


@pytest.mark.parametrize("fault", ["altered_token", "dropped_rows"])
def test_an_altered_or_dropped_answer_fails(fault):
    with faults.FAULTS[fault]():
        out = run_tiny(tiny_bert_cell(), seconds=0.3)
    assert not out["result"]["correct"]


def test_a_nan_answer_fails(monkeypatch):
    from ultrafnd_git_tpu_torch.models.bert import DeviceBertEncoder

    encode = DeviceBertEncoder.encode_ids

    def nan_rows(self, ids, mask):
        rows = encode(self, ids, mask)
        rows[0, 0] = float("nan")
        return rows

    monkeypatch.setattr(DeviceBertEncoder, "encode_ids", nan_rows)
    out = run_tiny(tiny_bert_cell(), seconds=0.3)
    assert not out["result"]["correct"]
