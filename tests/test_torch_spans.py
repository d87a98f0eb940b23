"""PyTorch port, the program's spans (`utils/spans.py`) on the CPU.

Off, a span is the one shared no-op object and a train step or a request
makes none; on, a train step is one `train.step` tree (upload, a forward
of five stages and a backward a microbatch, the optimizer's norm and K1)
and an `encode_ids` call one `encode.request` tree (the plan's pad, one
upload, a forward and a pool a chunk, one download, then the finish),
every span carrying its root's id inside its parent's interval; the spans
map onto the profiler's clock within 100 us of a `record_function` block
they hold; `profiler_trace` writes them into `fit.trace.json` as a track
of their own.
"""
import json
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from test_torch_moe import one_torch_thread, small_cache  # noqa: F401 (autouse fixture)
from ultrafnd_git_tpu_torch.models.bert import BertEncoder, DeviceBertEncoder, hf_config
from ultrafnd_git_tpu_torch.training import trainer as port
from ultrafnd_git_tpu_torch.training.loop import profiler_trace
from ultrafnd_git_tpu_torch.utils import spans

STAGES = ["forward.text_tower", "forward.gnn", "forward.fusion", "forward.classifier",
          "forward.loss"]
CHUNK = ["encode.forward", "encode.pool"]
BERT = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
            vocab_size=100, max_position_embeddings=64, type_vocab_size=2,
            layer_norm_eps=1e-12)
NEAR_NS = 100_000  # 100 us


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _trainer(tmp_path, accum=1):
    cfg = port.TrainConfig(out_dir=str(tmp_path / "out"), cache_to_disk=False, batch_size=4,
                           grad_accum=accum, epochs=1, seed=0, log_metrics_jsonl=False,
                           train_text_tower=True, text_tower_depth=1, text_tower_heads=4)
    return port.ForensicTrainer(cfg, cache=small_cache(), device="cpu")


def _encoder():
    module = BertEncoder.from_config(hf_config(BERT))
    return DeviceBertEncoder(module.state_dict(), None, dim=32, max_length=32, batch_size=2,
                             device="cpu", config=BERT)


def _ids(rows=3, cols=10, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, BERT["vocab_size"], size=(rows, cols)).astype(np.int64)
    mask = (np.arange(cols)[None] < rng.integers(2, cols + 1, size=rows)[:, None])
    return ids, mask.astype(np.float32)


def _tree(recorded):
    """{id: span} and {parent id: [children in start order]}, after checking
    that every span carries its root's id and lies inside its parent."""
    by_id = {s[1]: s for s in recorded}
    kids = {}
    for s in sorted(recorded, key=lambda s: s[4]):
        name, sid, parent, root, start, end = s
        assert start <= end
        if parent is None:
            assert root == sid, name
            continue
        p = by_id[parent]
        assert root == p[3], name
        assert p[4] <= start and end <= p[5], (name, p[0])
        kids.setdefault(parent, []).append(s)
    return by_id, kids


def test_off_a_span_is_one_shared_object_and_a_step_and_a_request_make_none(tmp_path,
                                                                              monkeypatch):
    made = []

    class Counted(spans._Open):
        def __init__(self, *a):
            made.append(a[0])
            super().__init__(*a)

    monkeypatch.setattr(spans, "_Open", Counted)
    assert spans.span("train.step") is spans.span("encode.request") is spans.OFF
    t = _trainer(tmp_path)
    chunk, mask, _ = t.epoch_batches(t.tr_idx, True)[0]
    t.train_step(chunk, mask)
    _encoder().encode_ids(*_ids())
    assert made == []
    with spans.recording() as rec:
        with spans.span("x"):
            with pytest.raises(RuntimeError, match="one block at a time"):
                with spans.recording():
                    pass
    assert made == ["x"] and [s[0] for s in rec.spans] == ["x"]


@pytest.mark.parametrize("accum", [1, 2])
def test_a_train_step_is_one_tree_of_its_phases(tmp_path, accum):
    t = _trainer(tmp_path, accum)
    batches = t.epoch_batches(t.tr_idx, True)
    with spans.recording() as rec:
        for chunk, mask, _ in batches[:2]:
            t.train_step(chunk, mask)
    by_id, kids = _tree(rec.spans)
    roots = [s for s in rec.spans if s[2] is None]
    assert [s[0] for s in roots] == ["train.step"] * 2
    for root in roots:
        names = [s[0] for s in kids[root[1]]]
        assert names == (["train.upload"] + ["train.forward", "train.backward"] * accum
                         + ["train.optimizer"])
        for s in kids[root[1]]:
            want = {"train.forward": STAGES, "train.optimizer": ["optimizer.norm",
                                                                 "optimizer.k1"]}.get(s[0], [])
            assert [c[0] for c in kids.get(s[1], [])] == want, s[0]
    assert len({s[3] for s in rec.spans}) == 2


def test_an_encode_of_two_chunks_is_one_request_tree():
    enc = _encoder()
    ids, mask = _ids(rows=3)
    with spans.recording() as rec:
        out = enc.encode_ids(ids, mask)
    assert out.shape == (3, 32)
    by_id, kids = _tree(rec.spans)
    (root,) = [s for s in rec.spans if s[2] is None]
    assert root[0] == "encode.request"
    assert [s[0] for s in kids[root[1]]] == (["encode.pad", "encode.upload"] + CHUNK * 2
                                             + ["encode.download", "encode.finish"])
    assert all(s[3] == root[1] for s in rec.spans)


def test_spans_map_onto_the_profilers_clock():
    with record_function("warm"):  # the first block pays record_function's own set-up
        pass
    with spans.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm"):
                pass
            for _ in range(3):
                with spans.span("block"):
                    with record_function("block"):
                        torch.randn(64, 64) @ torch.randn(64, 64)
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events() if e.name() == "block")
    mapped = sorted((s[4], s[5]) for s in rec.on_epoch_clock())
    assert len(events) == len(mapped) == 3
    for (s0, s1), (e0, e1) in zip(mapped, events):
        assert s0 - NEAR_NS <= e0 <= s0 + NEAR_NS, (s0, e0)
        assert s1 - NEAR_NS <= e1 <= s1 + NEAR_NS, (s1, e1)


def test_profiler_trace_writes_the_spans_as_a_track_of_the_trace(tmp_path):
    with profiler_trace(str(tmp_path / "prof"), torch.device("cpu")):
        with spans.span("train.step"):
            with spans.span("train.forward"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.loads((tmp_path / "prof" / "fit.trace.json").read_text())
    events = trace["traceEvents"]
    track = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(track) == {"train.step", "train.forward"}
    assert track["train.forward"]["args"]["parent"] == track["train.step"]["args"]["id"]
    assert any(e.get("name") == "thread_name" and e["args"]["name"] == "program spans"
               for e in events)
    fwd = track["train.forward"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert fwd["ts"] - 100 <= mm["ts"] and mm["ts"] + mm["dur"] <= fwd["ts"] + fwd["dur"] + 100
