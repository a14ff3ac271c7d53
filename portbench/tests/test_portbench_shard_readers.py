"""The readers of the four-card cell's shard and DP-table metrics
(`pull_lag_ms`, `drain_us_per_dp`) on made spans: their values on a made
tick of four shards, and None on spans without the `shard` field or
with no counters (a program from before them)."""

import importlib.util
from types import SimpleNamespace
from typing import NamedTuple, Optional

import pytest

from pb_tiny import REPO

pytest.importorskip("torch")

from kangaroo_torch.utils import spans as program_spans  # noqa: E402
from kangaroo_torch.utils.spans import Span  # noqa: E402
from portbench import spans  # noqa: E402


class OldSpan(NamedTuple):
    """A span as a program from before the `shard` field records it."""
    id: int
    name: str
    start: int
    end: int
    parent: Optional[int]
    serial: int

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


def _made():
    """One solve() call of two drained ticks on four shards, then its
    final drain (ns): shard 0's compaction ends at 20 and 115, the
    ticks' launches start at 50 and 140; each drain is 40 ns with a
    10-ns reset inside."""
    out = [Span(1, "solve", 0, 300, None, 1)]
    nid = 2
    for tick, t in ((2, 0), (20, 95)):
        out.append(Span(tick, "tick", t + 1, t + 95, 1, 1))
        for i in range(4):
            c0 = t + 5 + 5 * i
            out += [Span(tick + 1 + 2 * i, "compact.wait", c0, c0 + 2,
                         tick, 1, i),
                    Span(tick + 2 + 2 * i, "compact", c0 + 2, c0 + 15,
                         tick, 1, i)]
        launch = 50 if tick == 2 else 140
        out += [Span(tick + 9, "launch", launch, launch + 5, tick, 1),
                Span(tick + 10, "drain", t + 60, t + 100, tick, 1),
                Span(tick + 11, "reset", t + 70, t + 80, tick + 10, 1)]
        nid = tick + 12
    out.append(Span(nid, "finish", 200, 290, 1, 1))
    out += [Span(nid + 1 + i, "compact", 205 + i, 206 + i, nid, 1, i)
            for i in range(4)]
    return out


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "pb_test_" + name.replace(".", "_"),
        REPO / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CTX = {"run": None, "trace": None,
       "outcome": SimpleNamespace(program={"ticks": 2})}


def test_pull_lag_on_a_made_four_shard_tick(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: (_made(), 0))
    # (50 - 20) and (140 - 115) ns; the final drain has no launch
    assert _reader("pull_lag_ms").read(CTX) == pytest.approx(27.5e-6)


def test_drain_per_dp_on_a_made_four_shard_tick(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: (_made(), 0))
    monkeypatch.setattr(program_spans, "counters",
                        lambda serial: {"dps": 1000} if serial == 1 else {})
    # two drains of 40 ns, each less its 10-ns reset, over 1000 DPs
    assert _reader("drain_us_per_dp").read(CTX) == pytest.approx(6e-5)


def test_readers_without_the_shard_field_give_none(monkeypatch):
    old = [OldSpan(*s[:6]) for s in _made()]
    monkeypatch.setattr(spans, "recorded", lambda: (old, 0))
    assert _reader("pull_lag_ms").read(CTX) is None


def test_readers_without_counters_give_none(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: (_made(), 0))
    monkeypatch.delattr(program_spans, "counters")
    assert _reader("drain_us_per_dp").read(CTX) is None
    monkeypatch.setattr(program_spans, "counters", lambda serial: {},
                        raising=False)
    assert _reader("drain_us_per_dp").read(CTX) is None


@pytest.mark.parametrize("name", ["pull_lag_ms", "drain_us_per_dp"])
def test_readers_without_spans_give_none(monkeypatch, name):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert _reader(name).read(CTX) is None
