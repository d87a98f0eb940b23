"""The numbers that decide `correct`: each a gap between the program's
output and the plain reference's, held against its limit (the cell's
`workloads/<cell>.json`, set from readings of sound runs and of the
control; PERF.md gives both)."""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch


def finite_or_inf(x: float) -> float:
    """x, or inf where it is NaN: a NaN gap must not vanish under max()."""
    return math.inf if math.isnan(x) else x


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_norm_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    keys = list(leaves) if leaves is not None else list(ref)
    if set(keys) - set(prog):
        raise ValueError(f"the program has no leaves {sorted(set(keys) - set(prog))[:5]}")
    rn = norms({k: ref[k] for k in keys})
    pn = norms({k: prog[k] for k in keys})
    med = statistics.median(rn.values())
    return {k: finite_or_inf(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)) for k in keys}


def median_and_worst(gaps: Dict[str, float]) -> Tuple[float, float, str]:
    """(the median leaf's gap, the worst leaf's gap, the worst leaf). A NaN
    or infinite gap anywhere makes the median infinite too."""
    worst = max(gaps, key=gaps.get)
    if not math.isfinite(gaps[worst]):
        return math.inf, math.inf, worst
    return statistics.median(gaps.values()), gaps[worst], worst


def moving_leaves(grad1: Dict[str, torch.Tensor], share: float = 1e-3):
    """The leaves whose first gradient in the reference is at least `share`
    of the median leaf's norm: the others (a head the loss does not read,
    the temperature) move by weight decay and round-off alone."""
    n = norms(grad1)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= share * med]


def max_row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest element-wise gap between two sets of unit rows."""
    if prog.shape != ref.shape:
        return math.inf
    return finite_or_inf(float((prog.double() - ref.double()).abs().max()))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} of every number compared; a number
    without a limit, or a limit without its number, is a fault of the
    benchmark."""
    if set(numbers) != set(limits):
        raise KeyError(f"numbers {sorted(numbers)} against limits {sorted(limits)}")
    return {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number at or under its limit (a NaN passes nothing)."""
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
