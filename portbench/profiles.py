"""The traced run's profiles, reduced to device time.

`DeviceTrace` records the device's operations over the whole window with
`torch.profiler`'s CUDA activity alone (no host operations recorded, no
shapes, no stacks), so that what it costs the host is one CUPTI record a
launch. `record()` gives what the metric readers and the result's
`device` read: each device operation's total time by name, the busy time
(the union of the operations' intervals) and the window's wall time.

`host_gaps` names the device's idle gaps by the host operation running
during each. That needs the host's operations, which cost far more to
record, so it profiles a few units after the window has closed, and only
the result's `breakdown` reads it."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

TOP = 10  # entries of each breakdown list
NAME = 160  # characters of a name kept in the breakdown
SCAN = 512  # host operations looked at, back from a gap's middle, for the one running


def _activities(host: bool):
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts or [ProfilerActivity.CPU]


def _events(prof) -> Tuple[List[Tuple[str, float, float]], List[Tuple[float, float, str]]]:
    """(device operations (name, start_us, end_us), host operations
    (start_us, end_us, name)) of a stopped profile."""
    from torch.autograd import DeviceType

    dev, host = [], []
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None and hasattr(raw, "events"):
        for e in raw.events():
            s = e.start_ns() / 1e3
            item = (e.name(), s, s + e.duration_ns() / 1e3)
            if e.device_type() == DeviceType.CUDA:
                dev.append(item)
            elif e.device_type() == DeviceType.CPU:
                host.append((item[1], item[2], item[0]))
        return dev, host
    for e in prof.events():  # an older torch: the parsed events
        tr = e.time_range
        item = (e.name, float(tr.start), float(tr.end))
        if e.device_type == DeviceType.CUDA:
            dev.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append((item[1], item[2], item[0]))
    return dev, host


class DeviceTrace:
    """The device's operations over the window (`start()` before its first
    call, `stop()` once it has drained)."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=_activities(host=False))
        self.prof.start()

    def stop(self, window_s: float) -> Dict[str, Any]:
        self.prof.stop()
        ops, _ = _events(self.prof)
        self.prof = None
        return summarise(ops, window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def summarise(ops: List[Tuple[str, float, float]], window_s: float) -> Dict[str, Any]:
    """{"by_name": {name: device s}, "launches", "busy_s", "window_s",
    "span_s" (first operation's start to the last one's end),
    "device_ops"} of the device operations (name, start_us, end_us)."""
    merged = _union([(s, e) for _, s, e in ops if e > s])
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in ops:
        by_name[name] += (e - s) / 1e6
    device_ops = sorted(([n[:NAME], t] for n, t in by_name.items()), key=lambda x: -x[1])[:TOP]
    return {"by_name": dict(by_name), "launches": len(ops),
            "busy_s": sum(e - s for s, e in merged) / 1e6, "window_s": window_s,
            "span_s": (merged[-1][1] - merged[0][0]) / 1e6 if merged else 0.0,
            "device_ops": device_ops}


def idle_gaps(ops: List[Tuple[str, float, float]],
              host: List[Tuple[float, float, str]]) -> List[List[Any]]:
    """The device's idle gaps, summed by the innermost host operation
    running at each gap's middle, longest first."""
    merged = _union([(s, e) for _, s, e in ops if e > s])
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        name = "no host operation"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(-1, last - SCAN), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += (s1 - e0) / 1e6
    return sorted(([n[:NAME], t] for n, t in gaps.items()), key=lambda x: -x[1])[:TOP]


def host_gaps(sync: Callable[[], None], units: List[Callable[[], Any]]) -> List[List[Any]]:
    """`idle_gaps` over `units` run back to back under a profile of the
    host's operations and the device's (drained before and after)."""
    from torch.profiler import profile

    sync()
    prof = profile(activities=_activities(host=True))
    prof.start()
    for unit in units:
        unit()
    sync()
    prof.stop()
    return idle_gaps(*_events(prof))
