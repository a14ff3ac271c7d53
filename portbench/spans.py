"""The program's spans (`kangaroo_torch.utils.spans`) as the per-layer
readers see them: grouped by `solve()` call, their self times, and the
card's idle time of a trace labelled by the innermost span open.

A span's self time is its duration less its child spans'.  A checkout
whose program records no spans (before they were added) gives None
everywhere, never an error.

The batch driver's calls: the first is set-up's warm-up key, the next
`len(program["keys"])` are the window's first pass, which is never
traced, and the rest are the traced passes.  The search driver's window
is its last call.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

def recorded() -> Optional[tuple]:
    """(spans, dropped) of this process, or None without a recorder."""
    try:
        from kangaroo_torch.utils import spans
    except ImportError:
        return None
    return spans.recorded(), spans.dropped()


class Call:
    """The spans of one `solve()` call (one serial)."""

    def __init__(self, spans: list):
        self.spans = spans
        self.children: Dict[int, list] = defaultdict(list)
        for s in spans:
            if s.parent is not None:
                self.children[s.parent].append(s)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def seconds(self, name: str) -> float:
        return sum(s.seconds for s in self.named(name))

    def self_seconds(self, name: str) -> float:
        return sum(s.seconds - sum(c.seconds for c in self.children[s.id])
                   for s in self.named(name))

    @property
    def ticks(self) -> int:
        return len(self.named("tick"))


def calls() -> Optional[List[Call]]:
    """Every `solve()` call whose spans are all held, in call order."""
    rec = recorded()
    if rec is None:
        return None
    spans, _ = rec
    by_serial: Dict[int, list] = defaultdict(list)
    for s in spans:
        by_serial[s.serial].append(s)
    out = [Call(v) for _, v in sorted(by_serial.items())]
    return [c for c in out if len(c.named("solve")) == 1] or None


def first_pass(ctx) -> Optional[List[Call]]:
    """The batch window's first, untraced pass: the calls after the
    warm-up key, checked against the driver's own record of each key's
    herd seconds and ticks."""
    keys = ctx["outcome"].program.get("keys")
    rec = recorded()
    if not keys or rec is None or rec[1]:
        return None
    cs = calls()
    if cs is None or len(cs) < 1 + len(keys):
        return None
    got = cs[1:1 + len(keys)]
    for c, k in zip(got, keys):
        if c.ticks != k[2] or c.seconds("herd") != k[0]:
            return None
    return got


def traced_passes(ctx) -> Optional[List[Call]]:
    """The batch calls after the first pass, which the trace covers."""
    keys = ctx["outcome"].program.get("keys")
    if first_pass(ctx) is None:
        return None
    rest = calls()[1 + len(keys):]
    return rest or None


def window(ctx) -> Optional[Call]:
    """The search's window: its last call, checked against its ticks."""
    cs = calls()
    ticks = ctx["outcome"].program.get("ticks")
    if not cs or cs[-1].ticks != ticks:
        return None
    return cs[-1]


def _idle(trace) -> List[Tuple[int, int]]:
    """The busiest card's idle gaps from its first to its last operation."""
    busiest = max(trace.devices, key=lambda d: sum(
        e - s for s, e in trace.busy_intervals(d)))
    iv = trace.busy_intervals(busiest)
    return [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)
            if iv[i + 1][0] > iv[i][1]]


def _innermost(spans: list) -> List[Tuple[int, int, str]]:
    """Disjoint (start, end, name) pieces of the spans' union, each named
    by the innermost span open there (spans nest on one thread)."""
    kids: Dict[Optional[int], list] = defaultdict(list)
    ids = {s.id for s in spans}
    for s in spans:
        kids[s.parent if s.parent in ids else None].append(s)
    out: List[Tuple[int, int, str]] = []
    todo = list(kids[None])
    while todo:
        s = todo.pop()
        t = s.start
        for c in sorted(kids[s.id], key=lambda c: c.start):
            if c.start > t:
                out.append((t, c.start, s.name))
            t = max(t, c.end)
            todo.append(c)
        if s.end > t:
            out.append((t, s.end, s.name))
    return sorted(out)


def idle_by_span(trace, spans: Optional[list] = None
                 ) -> Optional[Dict[str, float]]:
    """The card's idle seconds over the trace, by the innermost span open
    (`none` where no span is open); the spans are this process's unless
    given."""
    if spans is None:
        rec = recorded()
        spans = rec[0] if rec is not None else None
    if trace is None or not trace.ops or spans is None:
        return None
    idle = _idle(trace)
    if not idle:
        return {}
    lo, hi = idle[0][0], idle[-1][1]
    pieces = _innermost([s for s in spans if s.end > lo and s.start < hi])
    starts = [p[0] for p in pieces]
    ns: Dict[str, int] = defaultdict(int)
    for a, b in idle:
        ns["none"] += b - a
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(pieces) and pieces[i][0] < b:
            s, e, name = pieces[i]
            cut = min(b, e) - max(a, s)
            if cut > 0:
                ns[name] += cut
                ns["none"] -= cut
            i += 1
    return {k: v * 1e-9 for k, v in ns.items()}


def ops_inside(trace, spans: list) -> int:
    """Device operations of the trace that start inside one of the
    spans."""
    starts = sorted(o.start_ns for o in trace.ops)
    return sum(bisect.bisect_right(starts, s.end)
               - bisect.bisect_left(starts, s.start) for s in spans)
