"""Work counts of the port's kernels, from shapes, each product counted once.

A module per kernel: `KERNEL`, a regular expression that the kernel's name
in the profiler's trace matches, and `work(shape) -> (flop, bytes)`. Each
input byte is read once and each output byte written once, whatever the
kernel reads again; each matrix product is 2 m n k operations, whatever
implements it (3xTF32 or one pass)."""
from __future__ import annotations

from typing import Dict, Tuple


def bound_s(work: Tuple[float, float], peaks: Dict[str, float], rate: str) -> float:
    """The least time the card could take for (flop, bytes): the larger of
    the bytes over the memory rate and the operations over `rate`'s peak."""
    flop, nbytes = work
    return max(nbytes / peaks["bytes_per_s"], flop / peaks[rate])


def bound_by(work: Tuple[float, float], peaks: Dict[str, float], rate: str) -> str:
    flop, nbytes = work
    return "bytes" if nbytes / peaks["bytes_per_s"] >= flop / peaks[rate] else "operations"
