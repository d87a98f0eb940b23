"""What the metric readers (`metrics/<metric>.py`) share: each reads the
run's record and returns a number, or None where it finds nothing to read
(then the metric is left out of the result line; a share of a roofline or
a peak is never 0 for want of a reading).

The record: `setup_s`; `window_s` (host clock, from the window's first call
to the drained device); `units`, one a step or request of the window,
{"t0", "t1" (None for a request that failed), "rows", "tokens", "flops",
"attn_fwd", "attn_bwd" (the attention shapes it ran), "slots", "real" (a
traced encode's padded and real token slots)}; `trace` (the traced run's
whole window, `profiles.py`: "by_name" device seconds, "busy_s",
"window_s"); `memory`; `cfg`; `peaks` of the card (None for a card
`peaks.py` does not hold)."""
from __future__ import annotations

import importlib
import math
import re
import statistics
from typing import Any, Dict, List, Optional

from portbench.rooflines import bound_s


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or under it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def latencies_ms(rec: Dict[str, Any]) -> List[float]:
    """Every request's time, call to rows on the host; a failed one is
    infinitely late."""
    return [math.inf if u["t1"] is None else 1e3 * (u["t1"] - u["t0"]) for u in rec["units"]]


def window_rate(rec: Dict[str, Any], key: str) -> Optional[float]:
    """The window's total of `key` over its finished units, a second."""
    if not rec["units"] or rec["window_s"] <= 0:
        return None
    return sum(u[key] for u in rec["units"] if u["t1"] is not None) / rec["window_s"]


def device_ms(rec: Dict[str, Any], pattern: Optional[str] = None) -> Optional[float]:
    """Device time (ms) of the window's operations whose name matches
    `pattern` (all of them without one)."""
    tr = rec.get("trace")
    if not tr or not tr["by_name"]:
        return None
    rx = re.compile(pattern, re.IGNORECASE) if pattern else None
    return 1e3 * sum(t for n, t in tr["by_name"].items() if rx is None or rx.search(n))


def share_of_device(rec: Dict[str, Any], pattern: str) -> Optional[float]:
    part, total = device_ms(rec, pattern), device_ms(rec)
    if part is None or not total:
        return None
    return 100.0 * part / total


def idle_share(rec: Dict[str, Any]) -> Optional[float]:
    tr = rec.get("trace")
    if not tr or not tr["by_name"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline(rec: Dict[str, Any], kernel: str, shapes_key: str) -> Optional[float]:
    """The kernel's share of its roofline over the window: the bound of
    every launch its units made (their `shapes_key` shapes) over the
    kernel's device time, in %."""
    peaks = rec.get("peaks")
    mod = importlib.import_module(f"portbench.rooflines.{kernel}")
    ms = device_ms(rec, mod.KERNEL)
    if not peaks or not ms:
        return None
    bound = sum(bound_s(mod.work(s), peaks, mod.RATE)
                for u in rec["units"] for s in u.get(shapes_key, ()))
    return 100.0 * bound * 1e3 / ms if bound else None


def mfu(rec: Dict[str, Any]) -> Optional[float]:
    """Model FLOPs of the window's finished units over its wall time,
    against the configuration's peak, in %."""
    peaks = rec.get("peaks")
    if not peaks:
        return None
    flop = sum(u["flops"] for u in rec["units"] if u["t1"] is not None)
    if rec["window_s"] <= 0 or not flop:
        return None
    return 100.0 * flop / rec["window_s"] / peaks[rec["cfg"]["mfu_peak"]]


def step_period_ms(rec: Dict[str, Any]) -> Optional[float]:
    """The median time between two consecutive steps' returns (the host
    waits for the device once its queue is full, so this is a step's time
    in the steady loop)."""
    u = rec["units"]
    gaps = [1e3 * (b["t1"] - a["t1"]) for a, b in zip(u, u[1:])]
    return statistics.median(gaps) if gaps else None
