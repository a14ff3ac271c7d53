"""Spans: named intervals of the solver's work at its layer boundaries,
recorded always, in fixed memory, on the clock of the device trace.

    from kangaroo_torch.utils import spans

    with spans.span("drain") as s:
        ...
    s.seconds                  # its duration, once closed

A span holds its name, its start and end (ns on `time.time_ns`, the
clock that torch.profiler stamps its host and device events with, so
spans and a device trace share one timeline), the span open around it
on the same thread (its parent) and a serial number.  A span
opened with none open around it (a `solve()` call) takes a new serial;
every span inside it shares that serial.  `add` records a span whose
times were taken elsewhere (a read on the watchdog's thread) inside the
span open on this thread.

The process's recorder keeps the last `CAP` closed spans and counts
those it dropped; `recorded()` returns them, oldest first, for readers
after a run.  There is no switch and no exporter.  `SolveStats`'s
timers (herd, compaction, save stall, loop) are read from these spans.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

CAP = 1 << 18
now = time.time_ns


class Span(NamedTuple):
    id: int
    name: str
    start: int               # ns, time.time_ns
    end: int
    parent: Optional[int]    # id of the span open around it, or None
    serial: int              # shared by a root span and every span inside

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Open:
    """A span being recorded: the context manager `span()` returns.
    `start`, `end` and `seconds` are set on entry and exit."""

    __slots__ = ("rec", "id", "name", "start", "end", "parent", "serial")

    def __init__(self, rec: "Recorder", name: str):
        self.rec = rec
        self.name = name
        self.end = 0

    def __enter__(self) -> "Open":
        stack = self.rec._stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top else None
        self.serial = top.serial if top else next(self.rec._serials)
        self.id = next(self.rec._ids)
        stack.append(self)
        self.start = now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = now()
        self.rec._stack().pop()
        self.rec._keep((self.id, self.name, self.start, self.end,
                        self.parent, self.serial))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Recorder:
    """Closed spans, the newest `cap` of them; `dropped` counts the older
    ones let go."""

    def __init__(self, cap: int = CAP):
        self._closed: deque = deque(maxlen=cap)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._serials = itertools.count(1)
        self.dropped = 0

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _keep(self, s: tuple) -> None:
        with self._lock:
            if len(self._closed) == self._closed.maxlen:
                self.dropped += 1
            self._closed.append(s)

    def span(self, name: str) -> Open:
        return Open(self, name)

    def add(self, name: str, start: int, end: int) -> Span:
        """Record a closed span of [start, end] (ns) inside the span open
        on this thread."""
        stack = self._stack()
        top = stack[-1] if stack else None
        s = Span(next(self._ids), name, start, end, top.id if top else None,
                 top.serial if top else next(self._serials))
        self._keep(tuple(s))
        return s

    def recorded(self) -> List[Span]:
        with self._lock:
            closed = list(self._closed)
        return [Span(*s) for s in closed]


_recorder = Recorder()
span = _recorder.span
add = _recorder.add
recorded = _recorder.recorded


def dropped() -> int:
    """Spans the process's recorder has let go (oldest first)."""
    return _recorder.dropped
