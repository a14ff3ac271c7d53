"""The device trace of a run's window (`--trace 1`): torch.profiler over
the window, read back as the card's kernels and the host's operations.

`busy_s` is the union of the intervals in which some operation ran on a
card (kernels, copies, sets), averaged over the cards the run uses;
`window_s` the host-clock length of the traced window.  The breakdown
names the device operations that took most time and the longest idle
gaps of the busiest card, each by the host operation that was running
across the gap's middle.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple


# device-timeline entries that are ranges of the profiler's own, not work
_NOT_DEVICE_WORK = ("ProfilerStep", "gpu_user_annotation")
# host calls shorter than this cannot hold the middle of a gap worth
# naming; leaving them out keeps the trace's reading short
_HOST_MIN_NS = 50_000


class DeviceOp(NamedTuple):
    name: str
    device: int
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    window_s: float
    ops: List[DeviceOp]
    host: List[Tuple[str, int, int]] = field(default_factory=list)
    devices: Tuple[int, ...] = (0,)

    def busy_intervals(self, device: int) -> List[Tuple[int, int]]:
        spans = sorted((o.start_ns, o.end_ns) for o in self.ops
                       if o.device == device)
        merged: List[Tuple[int, int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return merged

    def busy_s(self) -> float:
        per = [sum(e - s for s, e in self.busy_intervals(d)) * 1e-9
               for d in self.devices]
        return sum(per) / len(per)

    def kernels(self, substring: str) -> List[DeviceOp]:
        return [o for o in self.ops if substring in o.name]

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for o in self.ops:
            by_name[_short(o.name)] += (o.end_ns - o.start_ns) * 1e-9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busiest = max(self.devices, key=lambda d: sum(
            e - s for s, e in self.busy_intervals(d)))
        iv = self.busy_intervals(busiest)
        gaps = sorted(((iv[i + 1][0] - iv[i][1], iv[i][1], iv[i + 1][0])
                       for i in range(len(iv) - 1)), reverse=True)[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_at((a + b) // 2), g * 1e-9]
                              for g, a, b in gaps]}

    def _host_at(self, t_ns: int) -> str:
        """The outermost host operation running at t_ns."""
        best: Optional[Tuple[int, str]] = None
        for name, s, e in self.host:
            if s <= t_ns <= e and (best is None or s < best[0]):
                best = (s, name)
        return "host: " + (best[1] if best else "no CUDA call")


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


class Tracer:
    """Profiles the window when enabled; a no-op otherwise."""

    def __init__(self, enabled: bool, devices: Tuple[int, ...] = (0,)):
        self.enabled = enabled
        self.devices = devices
        self._prof = None
        self._t0 = 0.0
        self.trace: Optional[Trace] = None
        self.read_s = 0.0

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        # on a card only the device's activity (and the runtime calls
        # that launch it): recording every host operation would slow the
        # host-bound cells several times over
        acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [ProfilerActivity.CPU])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            for d in self.devices:
                torch.cuda.synchronize(d)
        window = time.perf_counter() - self._t0
        t_read = time.perf_counter()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        ops, host = [], []
        for ev in events:
            dur = int(ev.duration_ns())
            if ev.device_type() == DeviceType.CUDA:
                name = ev.name()
                if not name.startswith(_NOT_DEVICE_WORK):
                    start = int(ev.start_ns())
                    ops.append(DeviceOp(name, int(ev.device_index()), start,
                                        start + dur))
            elif dur >= _HOST_MIN_NS:
                start = int(ev.start_ns())
                host.append((ev.name(), start, start + dur))
        self._prof = None
        self.trace = Trace(window, ops, host, self.devices)
        self.read_s = time.perf_counter() - t_read


def idle_share(ctx):
    """Percent of the traced window with no operation on the card(s);
    nothing when the trace holds no device operation."""
    trace = ctx["trace"]
    if trace is None or not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
