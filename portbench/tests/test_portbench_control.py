"""The control on the card at a test's size: the plain reference computed
with TF32 on, put in the program's place, fails a number that the program
passes. (The cells' own readings, at their own sizes over a dozen seeds,
come from `calibrate.py` on the card; PERF.md gives them.)"""
import pytest
import torch

from portbench.tests.conftest import run_tiny, tiny_bert_cell, tiny_train_cell

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return "cuda"


def _tiny_train_on_the_card():
    cell = tiny_train_cell()
    cell.config["tower"].update(width=256, heads=2)  # D = 128, a width K2 is built for
    cell.config["corpus"]["text"] = 256
    return cell


@pytest.mark.parametrize("which", ["train", "bert"])
@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23])
def test_the_control_fails_where_the_program_passes(cuda, which, seed):
    cell = _tiny_train_on_the_card() if which == "train" else tiny_bert_cell(256, 4)
    out = run_tiny(cell, seed=seed, seconds=1.0, control=True, device=cuda)
    assert out["result"]["correct"], out["checks"]
    assert any(out["control"][k] > c["limit"] for k, c in out["checks"].items()), \
        (out["control"], out["checks"])
