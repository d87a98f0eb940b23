"""The attribution of device operations and idle gaps to the program's
spans (`portbench/spans.py`), on synthetic records, and the readers of
what the program counts."""
import threading
import time

import pytest

from portbench import harness, spans, window
from portbench.tests.conftest import tiny_bert_cell, tiny_train_cell
from ultrafnd_git_tpu_torch.kernels import adamw
from ultrafnd_git_tpu_torch.utils import spans as program

# a step [0, 100) us: upload [0, 5), forward [5, 40), backward [40, 90)
STEP = [("train.step", 1, None, 1, 0.0, 100.0), ("train.upload", 2, 1, 1, 0.0, 5.0),
        ("train.forward", 3, 1, 1, 5.0, 40.0), ("forward.gnn", 4, 3, 1, 10.0, 20.0),
        ("train.backward", 5, 1, 1, 40.0, 90.0)]


def test_a_backward_kernel_launched_from_another_thread_counts_in_train_backward():
    launched = []
    with program.recording() as rec:
        with program.span("train.step"):
            with program.span("train.backward"):
                # autograd's own thread launches while the caller waits
                worker = threading.Thread(target=lambda: launched.append(time.perf_counter_ns()))
                worker.start()
                worker.join(timeout=10)
                time.sleep(0.001)
    assert not worker.is_alive() and launched
    shift = rec.anchor[1] - rec.anchor[0]
    rows = [(n, i, p, r, s / 1e3, e / 1e3) for n, i, p, r, s, e in rec.on_epoch_clock()]
    t = (launched[0] + shift) / 1e3
    ops = [("flash_bwd_kernel", t + 50.0, t + 80.0, 7)]
    per_id = spans.attribute(ops, [("cudaLaunchKernel", t, t + 3.0, 7)], rows)
    assert spans.by_name(per_id, rows) == {"train.backward": pytest.approx(30e-6)}
    assert spans.by_name(per_id, rows, inclusive=True) == {
        "train.backward": pytest.approx(30e-6), "train.step": pytest.approx(30e-6)}


def test_operations_go_to_the_innermost_span_at_their_launch_or_to_unattributed():
    ops = [("gemm", 12.0, 30.0, 1), ("gemm", 30.0, 45.0, 2), ("copy", 110.0, 120.0, 3),
           ("memset", 120.0, 121.0, 4)]
    calls = [("cudaLaunchKernel", 11.0, 12.0, 1), ("cudaLaunchKernel", 6.0, 7.0, 2),
             ("cudaMemcpyAsync", 105.0, 106.0, 3)]  # the memset's call was not recorded
    per_id = spans.attribute(ops, calls, STEP)
    assert per_id == {4: pytest.approx(18e-6), 3: pytest.approx(15e-6),
                      None: pytest.approx(11e-6)}
    assert spans.by_name(per_id, STEP) == {"forward.gnn": pytest.approx(18e-6),
                                           "train.forward": pytest.approx(15e-6),
                                           spans.UNATTRIBUTED: pytest.approx(11e-6)}
    incl = spans.by_name(per_id, STEP, inclusive=True)
    assert incl["train.forward"] == pytest.approx(33e-6)
    assert incl["train.step"] == pytest.approx(33e-6)


def test_an_idle_gap_inside_and_one_outside_train_step_go_to_their_sides():
    ops = [("k", 50.0, 70.0, 1), ("k", 80.0, 95.0, 2), ("k", 130.0, 140.0, 3)]
    assert spans.gaps(ops) == [(70.0, 80.0), (95.0, 130.0)]
    assert spans.idle_by_span(ops, STEP) == {"train.backward": pytest.approx(10e-6),
                                             spans.UNATTRIBUTED: pytest.approx(35e-6)}
    # the second gap's first 5 us are still inside the step
    assert spans.idle_inside(ops, STEP, "train.step") == pytest.approx(15e-6)
    rec = {"trace": {"ops": ops, "launches": [("cudaLaunchKernel", 41.0, 42.0, 1)],
                     "spans": STEP, "counters": {"start": {"adamw.table_builds": 3},
                                                 "end": {"adamw.table_builds": 5}}}}
    assert spans.idle_ms(rec, "train.step") == pytest.approx(15e-3)
    assert spans.phase_ms(rec, "train.backward", "train.step") == pytest.approx(20e-3)
    assert spans.phase_ms(rec, "train.forward", "train.step") == 0.0
    assert spans.counter_rate(rec, "adamw.table_builds", "train.step") == 2.0


@pytest.mark.parametrize("trace", [None, {}, {"by_name": {"k": 1.0}, "busy_s": 1.0}])
def test_each_reader_returns_none_without_spans_or_launches(trace):
    rec = {"trace": trace, "units": []}
    assert spans.phase_ms(rec, "train.forward", "train.step") is None
    assert spans.idle_ms(rec, "encode.request") is None
    assert spans.counter_rate(rec, "adamw.table_builds", "train.step") is None


def test_the_table_builds_reader_reads_the_programs_counters(monkeypatch):
    read = harness.metric_reader("train.k1_table_builds")
    monkeypatch.setattr(adamw, "launches", 0)
    assert read({}) is None
    monkeypatch.setattr(adamw, "launches", 8)
    monkeypatch.setattr(adamw, "table_builds", 2)
    assert read({}) == 0.25
    monkeypatch.delattr(adamw, "table_builds")  # a program without the counter
    assert read({}) is None


def test_synchronisations_are_counted_under_the_span_that_waited():
    calls = [("cudaStreamSynchronize", 45.0, 60.0, 9), ("cudaLaunchKernel", 46.0, 47.0, 10),
             ("cudaStreamSynchronize", 150.0, 151.0, 11)]
    assert spans.calls_by_span(calls, STEP, "Synchronize") == {
        "train.backward": [1, pytest.approx(15e-6)], spans.UNATTRIBUTED: [1, pytest.approx(1e-6)]}


@pytest.mark.parametrize("which", ["train", "bert"])
def test_the_traced_run_with_spans_keeps_the_windows_spans_and_counters(which):
    cell = tiny_train_cell() if which == "train" else tiny_bert_cell()
    out = spans.traced_run(cell, 2 ** 31 + 5, 0.5, True, time.perf_counter(), device="cpu")
    found = out["result"]["spans"]
    assert out["result"]["correct"] and found["on"] and found["spans_recorded"] > 0
    assert set(found["counters"]) == {"start", "end"}
    # no device operations on the CPU: nothing to attribute, no reading;
    # K1 runs its plain update there, so no table is built
    readings = dict(found["readings"])
    assert readings.pop("k1_table_builds", 0.0) == 0.0
    assert readings and all(v is None for v in readings.values())
    assert harness.driver(cell).drive is window.drive
