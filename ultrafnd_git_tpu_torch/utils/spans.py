"""The program's spans: named intervals of its own phases, kept in memory
while a block records them.

`span(name)` marks a phase: `with span("train.forward"): ...`. While no
block records, it returns one shared object whose enter and exit do
nothing, so an untraced run pays one check of a module-level bool a span.
Inside `recording()`, each span keeps `(name, id, parent id, root id,
start_ns, end_ns)` on `time.perf_counter_ns()`. Its parent is the span
open on the same thread when it began (None for a root), and every span
carries its root's id, so the spans of one step or one request share it.
A span reads the clock and nothing else: it never syncs the device and
touches no tensor.

`recording()` also keeps one anchor, a `(perf_counter_ns, time_ns)` pair
read together: `Recording.on_epoch_clock()` gives the spans on the
Unix-epoch nanoseconds of `torch.profiler`'s kineto events (`start_ns()`),
so a profile's device operations and the spans they ran under can be
matched (`training/loop.profiler_trace` writes them as a track of the
Chrome trace)."""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Iterator, List, Optional, Tuple

# (name, id, parent id or None, root id, start_ns, end_ns)
Span = Tuple[str, int, Optional[int], int, int, int]

_on = False  # whether a block records
_out: Optional[List[Span]] = None  # the recording block's list
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "out", "id", "parent", "root", "start")

    def __init__(self, name: str, out: List[Span]):
        self.name, self.out = name, out

    def __enter__(self) -> None:
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        self.root = top.root if top is not None else self.id
        stack.append(self)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        _stack().pop()
        self.out.append((self.name, self.id, self.parent, self.root, self.start, end))


def span(name: str):
    """A context manager marking the phase `name` (a no-op unless recording)."""
    if not _on:
        return OFF
    return _Open(name, _out)


class Recording:
    """The spans a `recording()` block closed, in the order they closed,
    and its clock anchor."""

    def __init__(self):
        self.spans: List[Span] = []
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def on_epoch_clock(self) -> List[Span]:
        """The spans with start and end in Unix-epoch ns (kineto's clock)."""
        shift = self.anchor[1] - self.anchor[0]
        return [(n, i, p, r, s + shift, e + shift) for n, i, p, r, s, e in self.spans]


def active() -> bool:
    """Whether a `recording()` block is open: a counter that costs device
    work counts only then."""
    return _on


@contextmanager
def recording() -> Iterator[Recording]:
    """Record every span that begins inside the block, on any thread."""
    global _on, _out
    if _on:
        raise RuntimeError("spans are recorded by one block at a time")
    rec = Recording()
    _out, _on = rec.spans, True
    try:
        yield rec
    finally:
        _on, _out = False, None
