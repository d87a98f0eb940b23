"""The measured window, and the device helpers the drivers share.

`drive` calls a driver's `unit(i)` (one train step, one request) back to
back until `--seconds` have passed, then drains the device: the window's
wall time runs from the first call to the drained device. In a traced run
the device's operations are recorded over the whole window
(`profiles.DeviceTrace`), and once it has closed `host_units` more units run
under a profile of the host's operations, which names the idle gaps of the
result's `breakdown` (`profiles.host_gaps`) and nothing else."""
from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from portbench.profiles import DeviceTrace, host_gaps


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev: torch.device) -> int:
    """torch.cuda.max_memory_allocated since the last reset (0 off the card)."""
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def drive(dev: torch.device, seconds: float, trace: bool, host_units: int,
          unit: Callable[[int], Dict[str, Any]]
          ) -> Tuple[List[Dict[str, Any]], float, int, Optional[Dict[str, Any]]]:
    """(the window's units, window_s, the window's peak bytes, the traced
    run's record). The units run after the window for `host_gaps` are not
    returned: the caller drops whatever else they left."""
    tracer = DeviceTrace() if trace else None
    if tracer is not None:
        tracer.start()
    units: List[Dict[str, Any]] = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        units.append(unit(len(units)))
    sync(dev)
    window_s = time.perf_counter() - t0
    peak = peak_bytes(dev)
    if tracer is None:
        return units, window_s, peak, None
    rec = tracer.stop(window_s)
    print(f"trace: {rec['launches']} device operations, busy {rec['busy_s']:.3f} s, first to "
          f"last {rec['span_s']:.3f} s of the {window_s:.3f} s window", file=sys.stderr)
    rec["idle_gaps"] = host_gaps(lambda: sync(dev), [
        (lambda k=k: unit(len(units) + k)) for k in range(host_units)])
    return units, window_s, peak, rec
