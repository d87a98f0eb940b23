"""The program's spans (`ultrafnd_git_tpu_torch/utils/spans.py`) over the
device's operations: which phase of the program launched each operation,
and which phase the host was in during each idle gap of the device.

Every time is on kineto's clock, in microseconds. `ops` are the device's
operations `(name, start, end, correlation id)`; `launches` the CUDA runtime
and driver calls `(name, start, end, correlation id)` that kineto records
beside them with the CUDA activity alone: an operation's launch is the call
of its correlation id. `spans` are the program's `(name, id, parent, root,
start, end)`.

- `attribute` gives each operation to the innermost span open at its
  launch, whatever thread launched it (autograd launches the backward from
  a thread of its own while the caller waits inside `train.backward`); an
  operation with no launch, or launched outside every span, goes to None.
- `idle_by_span` gives each idle gap of the device (between two stretches
  of the union of its operations) to the innermost span open at the gap's
  middle, or to `unattributed`.
- `idle_inside` is the idle time that falls inside the spans of one name.

The readings the phase metrics would take (device ms a step of the
operations launched inside `train.forward`, `train.backward`,
`train.optimizer`; the device's idle ms a step or request while the host is
inside `train.step` or `encode.request`; K1 table builds a step) are
`phase_ms`, `idle_ms` and `counter_rate` over a record that holds `ops`,
`launches`, `spans` and `counters`. The benchmark's traced run does not
keep those yet (PERF.md, Open questions), so a reader over it finds None.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> --spans <0|1>

runs one cell's traced run with the window recorded so (`--spans 0`: the
same run with the program's spans off, for what recording costs), prints
the attribution lists and the unattributed shares on stderr, and the
result line with the readings above under `spans` as the last line of
standard output.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple

from portbench.profiles import TOP, _union

Op = Tuple[str, float, float, int]
SpanRow = Tuple[str, int, Optional[int], int, float, float]
UNATTRIBUTED = "unattributed"
COUNTERS = (("adamw.table_builds", "ultrafnd_git_tpu_torch.kernels.adamw", "table_builds"),
            ("adamw.launches", "ultrafnd_git_tpu_torch.kernels.adamw", "launches"))


class SpanIndex:
    """The innermost span open at a time: of the spans whose [start, end)
    holds it, the one that began last (the deepest, where spans nest)."""

    def __init__(self, spans: Sequence[SpanRow]):
        self.points = sorted({s[4] for s in spans} | {s[5] for s in spans})
        by_start = sorted(spans, key=lambda s: s[4])
        active: List[SpanRow] = []
        k = 0
        self.inner: List[Optional[SpanRow]] = []
        for p in self.points:
            active = [s for s in active if s[5] > p]
            while k < len(by_start) and by_start[k][4] <= p:
                if by_start[k][5] > p:
                    active.append(by_start[k])
                k += 1
            self.inner.append(max(active, key=lambda s: (s[4], -s[5])) if active else None)

    def at(self, t: float) -> Optional[SpanRow]:
        i = bisect.bisect_right(self.points, t) - 1
        return self.inner[i] if i >= 0 else None


def gaps(ops: Sequence[Op]) -> List[Tuple[float, float]]:
    """The device's idle gaps: between consecutive stretches of the union
    of its operations' intervals."""
    merged = _union([(s, e) for _, s, e, _ in ops if e > s])
    return [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]


def attribute(ops: Sequence[Op], launches: Sequence[Op],
              spans: Sequence[SpanRow]) -> Dict[Optional[int], float]:
    """{span id (None: no span): device s} of the operations, each under the
    innermost span open at its launch."""
    launched = {corr: s for _, s, _, corr in launches}
    index = SpanIndex(spans)
    out: Dict[Optional[int], float] = defaultdict(float)
    for _, s, e, corr in ops:
        t = launched.get(corr)
        sp = index.at(t) if t is not None else None
        out[sp[1] if sp is not None else None] += (e - s) / 1e6
    return dict(out)


def by_name(per_id: Dict[Optional[int], float], spans: Sequence[SpanRow],
            inclusive: bool = False) -> Dict[str, float]:
    """The seconds of `attribute` summed by span name: each span's own
    (`inclusive` False) or with its descendants' (each name once a chain)."""
    rows = {s[1]: s for s in spans}
    out: Dict[str, float] = defaultdict(float)
    for sid, sec in per_id.items():
        if sid is None:
            out[UNATTRIBUTED] += sec
            continue
        names, cur = [], rows.get(sid)
        while cur is not None:
            if cur[0] not in names:
                names.append(cur[0])
            if not inclusive:
                break
            cur = rows.get(cur[2]) if cur[2] is not None else None
        for n in names:
            out[n] += sec
    return dict(out)


def idle_by_span(ops: Sequence[Op], spans: Sequence[SpanRow]) -> Dict[str, float]:
    """{span name or `unattributed`: idle s} of the gaps, each under the
    innermost span open at its middle."""
    index = SpanIndex(spans)
    out: Dict[str, float] = defaultdict(float)
    for e0, s1 in gaps(ops):
        sp = index.at(0.5 * (e0 + s1))
        out[sp[0] if sp is not None else UNATTRIBUTED] += (s1 - e0) / 1e6
    return dict(out)


def idle_inside(ops: Sequence[Op], spans: Sequence[SpanRow], name: str) -> float:
    """Idle seconds of the device while a span named `name` is open."""
    inside = _union([(s[4], s[5]) for s in spans if s[0] == name])
    total, j = 0.0, 0
    for g0, g1 in gaps(ops):
        while j < len(inside) and inside[j][1] <= g0:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < g1:
            total += min(g1, inside[k][1]) - max(g0, inside[k][0])
            k += 1
    return total / 1e6


def calls_by_span(launches: Sequence[Op], spans: Sequence[SpanRow],
                  word: str) -> Dict[str, List[float]]:
    """{span name: [count, host s]} of the runtime calls whose name holds
    `word` (a synchronisation: the host's wait), under the innermost span
    open at the call's start."""
    index = SpanIndex(spans)
    out: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, s, e, _ in launches:
        if word in name:
            sp = index.at(s)
            row = out[sp[0] if sp is not None else UNATTRIBUTED]
            row[0] += 1
            row[1] += (e - s) / 1e6
    return dict(out)


def _roots(tr: Dict[str, Any], root: str) -> int:
    return sum(1 for s in tr.get("spans") or () if s[0] == root and s[2] is None)


def phase_ms(rec: Dict[str, Any], phase: str, root: str) -> Optional[float]:
    """Device ms, a `root` span, of the operations launched inside the spans
    named `phase` and their descendants; None without spans or launches."""
    tr = rec.get("trace") or {}
    n = _roots(tr, root)
    if not n or not tr.get("ops") or not tr.get("launches"):
        return None
    per_id = attribute(tr["ops"], tr["launches"], tr["spans"])
    return 1e3 * by_name(per_id, tr["spans"], inclusive=True).get(phase, 0.0) / n


def idle_ms(rec: Dict[str, Any], root: str) -> Optional[float]:
    """The device's idle ms, a `root` span, while the host is inside one."""
    tr = rec.get("trace") or {}
    n = _roots(tr, root)
    if not n or not tr.get("ops"):
        return None
    return 1e3 * idle_inside(tr["ops"], tr["spans"], root) / n


def counter_rate(rec: Dict[str, Any], counter: str, root: str) -> Optional[float]:
    """A program counter's growth over the window, a `root` span."""
    tr = rec.get("trace") or {}
    n = _roots(tr, root)
    c = tr.get("counters") or {}
    start, end = (c.get(k, {}).get(counter) for k in ("start", "end"))
    if not n or start is None or end is None:
        return None
    return (end - start) / n


# --- the traced window with the program's spans ------------------------------

def counters() -> Dict[str, int]:
    """The port's counters that its modules hold (a module not imported, or
    a counter it lacks, is left out)."""
    out = {}
    for key, module, attr in COUNTERS:
        mod = sys.modules.get(module)
        value = getattr(mod, attr, None) if mod is not None else None
        if isinstance(value, int):
            out[key] = value
    return out


def events(prof) -> Tuple[List[Op], List[Op]]:
    """(device operations, CUDA runtime and driver calls) of a stopped
    profile, with their correlation ids."""
    from torch.autograd import DeviceType

    ops, calls = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        item = (e.name(), s, s + e.duration_ns() / 1e3, int(e.correlation_id()))
        if e.device_type() == DeviceType.CUDA:
            ops.append(item)
        elif e.name().startswith("cu"):
            calls.append(item)
    return ops, calls


def make_drive(record: bool, kept: Dict[str, Any]):
    """A stand-in for `window.drive`'s traced run: the same window under the
    same CUDA-only profile, with the program's spans recorded over the
    window alone (`record`), the counters at its start and end, and the raw
    operations and calls kept, also in `kept["trace"]`; no host-profiled
    units after it."""
    from portbench.profiles import _activities, summarise
    from portbench.window import peak_bytes, sync

    def drive(dev, seconds, trace, host_units, unit):
        import torch
        from torch.profiler import profile

        from ultrafnd_git_tpu_torch.utils import spans as program

        prof = profile(activities=_activities(host=False))
        prof.start()
        start = counters()
        units: List[Dict[str, Any]] = []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with program.recording() if record else nullcontext() as rec:
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                units.append(unit(len(units)))
            sync(dev)
            window_s = time.perf_counter() - t0
        end = counters()
        peak = peak_bytes(dev)
        prof.stop()
        ops, calls = events(prof)
        tr = summarise([op[:3] for op in ops], window_s)
        tr.update(idle_gaps=[], ops=ops, launches=calls, counters={"start": start, "end": end},
                  spans=[(n, i, p, r, s / 1e3, e / 1e3)
                         for n, i, p, r, s, e in rec.on_epoch_clock()] if rec else [])
        kept["trace"] = tr
        return units, window_s, peak, tr

    return drive


def _top(d: Dict[str, float], total: float) -> List[List[Any]]:
    rows = sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, round(v, 6), round(100.0 * v / total, 3) if total else None] for k, v in rows]


def report(tr: Dict[str, Any], root: str) -> Dict[str, Any]:
    """The attribution lists of a traced window (each [name, s, % of the
    total]) and the unattributed shares."""
    ops, calls, sp = tr["ops"], tr["launches"], tr["spans"]
    per_id = attribute(ops, calls, sp)
    device_s = sum(per_id.values())
    own = by_name(per_id, sp)
    incl = by_name(per_id, sp, inclusive=True)
    idle = idle_by_span(ops, sp)
    idle_s = sum(idle.values())
    return {"device_s": device_s, "idle_s": idle_s, "roots": _roots(tr, root),
            "unattributed_device_share": 100.0 * own.get(UNATTRIBUTED, 0.0) / device_s
            if device_s else None,
            "unattributed_idle_share": 100.0 * idle.get(UNATTRIBUTED, 0.0) / idle_s
            if idle_s else None,
            "launches_found": len({o[3] for o in ops} & {c[3] for c in calls}),
            "ops": len(ops), "device_by_span": _top(own, device_s),
            "device_by_phase": _top(incl, device_s), "idle_by_span": _top(idle, idle_s),
            "syncs_by_span": {k: [v[0], round(v[1], 6)]
                              for k, v in calls_by_span(calls, sp, "Synchronize").items()}}


def traced_run(cell, seed: int, seconds: float, record: bool, t0: float,
               device: str = "cuda") -> Dict[str, Any]:
    """`harness.run_cell`'s traced run of `cell` with `make_drive`'s window
    in the driver's `drive`: {"result" (with the readings under "spans"),
    "checks"}."""
    from portbench import harness

    mod = harness.driver(cell)
    kept: Dict[str, Any] = {}
    drive = mod.drive
    mod.drive = make_drive(record, kept)
    try:
        out = harness.run_cell(cell, seed, seconds, True, t0, device=device)
    finally:
        mod.drive = drive
    root = "train.step" if cell.traffic["driver"] == "train_step" else "encode.request"
    readings = {"idle_ms": idle_ms(kept, root)}
    if root == "train.step":
        for phase in ("train.forward", "train.backward", "train.optimizer"):
            readings[phase + "_ms"] = phase_ms(kept, phase, root)
        readings["k1_table_builds"] = counter_rate(kept, "adamw.table_builds", root)
    tr = kept["trace"]
    found = {"on": record, "readings": readings, "counters": tr["counters"],
             "spans_recorded": len(tr["spans"])}
    if record and tr["ops"]:
        found.update(report(tr, root))
    out["result"]["spans"] = found
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from portbench import harness

    t0 = time.perf_counter()
    p = argparse.ArgumentParser(prog="python3 -m portbench.spans",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.set_cache_env()
    out = traced_run(cell, args.seed, args.seconds, bool(args.spans), t0)
    found = out["result"]["spans"]
    print(json.dumps({k: v for k, v in found.items() if k != "readings"}, indent=1),
          file=sys.stderr)
    harness.emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
