"""Spans: named intervals of the solver's work at its layer boundaries,
recorded always, in fixed memory, on the clock of the device trace.

    from kangaroo_torch.utils import spans

    with spans.span("drain") as s:
        ...
    s.seconds                  # its duration, once closed

    with spans.span("compact", shard=2):   # one shard's work
        ...
    spans.count("dps", 4096)   # a counter of the solve() call open here

A span holds its name, its start and end (ns on `time.time_ns`, the
clock that torch.profiler stamps its host and device events with, so
spans and a device trace share one timeline), the span open around it
on the same thread (its parent), a serial number and, last, the index
of the lane shard whose work it times (`shard`; None for a span that is
not one shard's).  A span opened with none open around it (a `solve()`
call) takes a new serial; every span inside it shares that serial.
`add` records a span whose times were taken elsewhere (a read on the
watchdog's thread) inside the span open on this thread.

Counters: `count(name, n)` adds n to the counter `name` of the serial
open on this thread (serial 0 with no span open); `counters(serial)`
returns that serial's counters as a dict.

The process's recorder keeps the last `CAP` closed spans and counts
those it dropped, and the counters of the last `CAP_SERIALS` serials
that counted; `recorded()` returns the spans, oldest first, for readers
after a run.  There is no switch and no exporter.  `SolveStats`'s
timers (herd, compaction, save stall, loop) are read from these spans.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional

CAP = 1 << 18
CAP_SERIALS = 1 << 12
now = time.time_ns


class Span(NamedTuple):
    id: int
    name: str
    start: int               # ns, time.time_ns
    end: int
    parent: Optional[int]    # id of the span open around it, or None
    serial: int              # shared by a root span and every span inside
    shard: Optional[int] = None  # the lane shard whose work it times

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Open:
    """A span being recorded: the context manager `span()` returns.
    `start`, `end` and `seconds` are set on entry and exit."""

    __slots__ = ("rec", "id", "name", "start", "end", "parent", "serial",
                 "shard")

    def __init__(self, rec: "Recorder", name: str, shard: Optional[int]):
        self.rec = rec
        self.name = name
        self.shard = shard
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
                        self.parent, self.serial, self.shard))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Recorder:
    """Closed spans, the newest `cap` of them; `dropped` counts the older
    ones let go.  Counters by serial, those of the newest `cap_serials`
    serials that counted."""

    def __init__(self, cap: int = CAP, cap_serials: int = CAP_SERIALS):
        self._closed: deque = deque(maxlen=cap)
        self._counts: "OrderedDict[int, Dict[str, int]]" = OrderedDict()
        self._cap_serials = cap_serials
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

    def span(self, name: str, shard: Optional[int] = None) -> Open:
        return Open(self, name, shard)

    def add(self, name: str, start: int, end: int,
            shard: Optional[int] = None) -> Span:
        """Record a closed span of [start, end] (ns) inside the span open
        on this thread."""
        stack = self._stack()
        top = stack[-1] if stack else None
        s = Span(next(self._ids), name, start, end, top.id if top else None,
                 top.serial if top else next(self._serials), shard)
        self._keep(tuple(s))
        return s

    def count(self, name: str, n: int) -> None:
        """Add n to the counter `name` of the serial open on this
        thread."""
        stack = self._stack()
        serial = stack[-1].serial if stack else 0
        with self._lock:
            got = self._counts.get(serial)
            if got is None:
                got = self._counts[serial] = {}
                if len(self._counts) > self._cap_serials:
                    self._counts.popitem(last=False)
            got[name] = got.get(name, 0) + n

    def counters(self, serial: int) -> Dict[str, int]:
        """The counters of `serial` (empty if it counted nothing)."""
        with self._lock:
            return dict(self._counts.get(serial, {}))

    def recorded(self) -> List[Span]:
        with self._lock:
            closed = list(self._closed)
        return [Span(*s) for s in closed]


_recorder = Recorder()
span = _recorder.span
add = _recorder.add
count = _recorder.count
counters = _recorder.counters
recorded = _recorder.recorded


def dropped() -> int:
    """Spans the process's recorder has let go (oldest first)."""
    return _recorder.dropped
