"""PyTorch port: the numpy metrics against the JAX package's (scikit-learn)
metrics, exactly up to float rounding (atol 1e-12), on random scores with
ties, a degenerate one-class split and an empty split."""
import numpy as np
import pytest

from ultrafnd_git_tpu.training import metrics as ref
from ultrafnd_git_tpu_torch.training import metrics as ours


def _case(name):
    rng = np.random.default_rng(len(name))
    n = 200
    y = rng.integers(0, 2, size=n)
    p = rng.uniform(size=n)
    if name == "ties":
        p = np.round(p, 1)  # many tied scores, some at the 0.5 threshold
    elif name == "one_class":
        y = np.ones(n, int)
    elif name == "all_predicted_negative":
        p = p * 0.4
    elif name == "empty":
        y, p = y[:0], p[:0]
    forensic = {k: rng.uniform(size=len(y)) for k in
                ("semantic_conflict", "temporal_delay", "emotion_intensity")}
    return y, p, forensic


@pytest.mark.parametrize("name", ["random", "ties", "one_class", "all_predicted_negative",
                                  "empty"])
def test_epoch_metrics_match_jax_package(name):
    y, p, forensic = _case(name)
    got = ours.aggregate_epoch_metrics(y, p, forensic=forensic, threshold=0.5)
    want = ref.aggregate_epoch_metrics(y, p, forensic=forensic, threshold=0.5,
                                       include_cm=False)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, err_msg=k)


def test_pretty_print_matches_jax_package(capsys):
    y, p, forensic = _case("random")
    m = ref.aggregate_epoch_metrics(y, p, forensic=forensic)
    ref.pretty_print("val", m)
    want = capsys.readouterr().out
    ours.pretty_print("val", m)
    assert capsys.readouterr().out == want
