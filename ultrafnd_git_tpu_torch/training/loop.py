"""Trainer-skeleton helpers: the port's copy of `training/loop.py`.

The JAX module imports its Orbax checkpoint store (and so jax), so the
port keeps its own copy of the plumbing, with the same semantics: the
np.random shuffle-stream snapshot, ragged-batch padding, padded-row
flattening, val-metric improvement / early-stop accounting with gated
`best` writes, the cross-kind checkpoint guard, the JSONL epoch log and the
profiler bracket of a fit loop (`torch.profiler` in place of
`jax.profiler`).
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from ultrafnd_git_tpu_torch.training import checkpoint as ckpt
from ultrafnd_git_tpu_torch.utils import spans


def np_random_state_payload() -> list:
    """JSON-serialisable snapshot of np.random's global MT19937 state (the
    stream every epoch shuffle draws from)."""
    kind, keys, pos, has_gauss, cached = np.random.get_state()
    return [str(kind), np.asarray(keys, np.uint32).tolist(), int(pos),
            int(has_gauss), float(cached)]


def restore_np_random_state(payload) -> None:
    kind, keys, pos, has_gauss, cached = payload
    np.random.set_state(
        (str(kind), np.asarray(keys, np.uint32), int(pos), int(has_gauss),
         float(cached))
    )


def iter_padded_batches(
    order: np.ndarray, batch_size: int, shuffle: bool
) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Yield (chunk, mask, valid) fixed-shape batches; the ragged last batch
    repeats its final index and masks the padding. `shuffle` draws from
    np.random's global stream."""
    order = np.array(order, dtype=np.int32)
    if shuffle:
        np.random.shuffle(order)
    for s in range(0, len(order), batch_size):
        chunk = order[s : s + batch_size]
        valid = len(chunk)
        if valid < batch_size:
            chunk = np.concatenate(
                [chunk, np.full(batch_size - valid, chunk[-1], chunk.dtype)]
            )
        mask = np.zeros(batch_size, np.float32)
        mask[:valid] = 1.0
        yield chunk, mask, valid


def flatten_epoch_rows(batches, labels: np.ndarray, p1_mat, forensic_mat):
    """(y, p1, forensic (3, N)) of the valid rows, in step order, from the
    epoch's [(chunk, mask, valid)] list and stacked (S, B) / (S, 3, B)
    outputs."""
    p1_mat = np.asarray(p1_mat)
    forensic_mat = np.asarray(forensic_mat)
    y = np.concatenate([labels[c[:v]] for (c, _, v) in batches])
    p1 = np.concatenate([p1_mat[i, :v] for i, (_, _, v) in enumerate(batches)])
    f_cat = np.concatenate(
        [forensic_mat[i, :, :v] for i, (_, _, v) in enumerate(batches)], axis=1
    )
    return y, p1, f_cat


class ImprovementTracker:
    """Validation-metric improvement accounting and gated `best` writes:
    improvement = metric > best + 1e-4; `best` written only then (and only
    with save_best); early stop after `patience` epochs without one."""

    def __init__(self, out_dir: str, kind: str, save_best: bool, patience: int,
                 min_delta: float = 1e-4, best: float = -1.0, no_improve: int = 0):
        self.out_dir = out_dir
        self.kind = kind
        self.save_best = save_best
        self.patience = int(patience)
        self.min_delta = float(min_delta)
        self.best = float(best)
        self.no_improve = int(no_improve)

    def meta(self, epoch: int, cfg_dict: Dict[str, Any]) -> Dict[str, Any]:
        return {"trainer": self.kind, "epoch": epoch, "best_val_auc": self.best,
                "no_improve": self.no_improve, "cfg": cfg_dict}

    def update(self, val_metric: float, state, epoch: int, cfg_dict: Dict[str, Any],
               extra_meta: Optional[Dict[str, Any]] = None) -> bool:
        """Record one epoch's metric; write `best` on improvement."""
        if val_metric > self.best + self.min_delta:
            self.best = float(val_metric)
            self.no_improve = 0
            if self.save_best:
                meta = {**self.meta(epoch, cfg_dict), **(extra_meta or {})}
                ckpt.save_checkpoint(self.out_dir, "best", state, meta)
                print(f"  ↳ saved best checkpoint to {self.out_dir}/best "
                      f"(val_auc={val_metric:.3f})")
            return True
        self.no_improve += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.no_improve >= self.patience

    def announce_stop(self) -> None:
        print(f"↳ Early stopping (no val AUC improvement for {self.patience} epochs)")


def load_checkpoint_guarded(
    out_dir: str, name: str, expected_kind: str, action: str, map_location="cpu"
) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """A slot's (payload, meta) ONLY if its meta tag matches
    `expected_kind` (untagged meta counts as "v2"); None, with a visible
    warning, for a foreign or unreadable slot."""
    try:
        restored = ckpt.load_checkpoint(out_dir, name, map_location)
    except (OSError, RuntimeError, ValueError, KeyError) as exc:
        print(f"⚠️  failed to restore checkpoint {out_dir}/{name}: {exc!r}")
        return None
    if restored is None:
        return None
    kind = restored[1].get("trainer", "v2")
    if kind != expected_kind:
        print(f"⚠️  {name} checkpoint in {out_dir} was written by the "
              f"'{kind}' trainer — ignoring it and {action}")
        return None
    return restored


def log_jsonl(out_dir: str, enabled: bool, record: Dict[str, Any]) -> None:
    """Append one epoch record to <out_dir>/metrics.jsonl (in a process
    group, rank 0 alone appends)."""
    if not enabled or not ckpt.is_primary():
        return
    with open(os.path.join(out_dir, "metrics.jsonl"), "a", encoding="utf-8") as fh:
        fh.write(json.dumps(record, ensure_ascii=False) + "\n")


@contextmanager
def profiler_trace(profile_dir: Optional[str], device):
    """Bracket a fit loop with torch.profiler when `profile_dir` is set
    (JAX `training/loop.py:215-225`): host activity, and the device's
    kernels when `device` is a CUDA device, with the program's spans
    (`utils/spans.py`) recorded over the same block. On exit (a failed
    fit's too) the trace goes to `<profile_dir>/fit.trace.json`, in
    Chrome's trace format (chrome://tracing, Perfetto), the spans on a
    track of their own (`program spans`, on the profiler's clock)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if getattr(device, "type", str(device)) == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    with spans.recording() as rec:
        prof.start()
        try:
            yield
        finally:  # a failed fit keeps its trace, as jax.profiler's stop_trace
            prof.stop()
            path = out / "fit.trace.json"
            prof.export_chrome_trace(str(path))
            _add_span_track(path, rec)
            print(f"profiler trace: {path}")


def _add_span_track(path: Path, rec: "spans.Recording") -> None:
    """Append `rec`'s spans to the Chrome trace at `path`, as complete
    events on a thread of their own (tid 0) of this process, on the
    trace's clock (kineto's Unix-epoch microseconds less the trace's
    `baseTimeNanoseconds`)."""
    with open(path, "r", encoding="utf-8") as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "program spans"}})
    for name, sid, parent, root, start, end in rec.on_epoch_clock():
        events.append({"ph": "X", "cat": "program_span", "name": name, "pid": pid, "tid": 0,
                       "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
                       "args": {"id": sid, "parent": parent, "root": root}})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(trace, fh)
