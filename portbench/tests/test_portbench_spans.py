"""The readers of the program's spans (`portbench/spans.py` and the
span metrics of `portbench/metrics/`): the idle split by the innermost
open span on a made-up trace, each reader's None where the program
records no spans (a checkout from before them), and a traced CPU run of
each cell that reads every span metric, and no trace-only one where the
CPU trace holds no device operation."""

import importlib.util
from types import SimpleNamespace

import pytest

from pb_tiny import REPO, make_root, run_cell

pytest.importorskip("torch")

from kangaroo_torch.utils.spans import Span  # noqa: E402
from portbench import spans  # noqa: E402
from portbench.trace import DeviceOp, Trace  # noqa: E402

SPAN_ONLY = {"batch40.keys": ("jump_table_ms_per_key", "herd_draw_s_per_key",
                              "drain_ms_per_tick.batch"),
             "puzzle85.search": ("drain_ms_per_tick.search",
                                 "compact_ms_max"),
             "puzzle85.search-sym": ("drain_ms_per_tick.search",
                                     "compact_ms_max")}
TRACE_ONLY = {"batch40.keys": ("herd_ops_per_key", "idle_unspanned.batch")}
NEW = sorted({m for ms in list(SPAN_ONLY.values())
              + list(TRACE_ONLY.values()) for m in ms})


def _trace(*busy):
    return Trace(1.0, [DeviceOp("k", 0, a, b) for a, b in busy])


def test_idle_split_by_innermost_span():
    trace = _trace((0, 10), (30, 40), (70, 100), (110, 120))
    made = [Span(1, "solve", 5, 95, None, 1),
            Span(2, "tick", 12, 50, 1, 1),
            Span(3, "drain", 20, 35, 2, 1),
            Span(4, "reset", 22, 25, 3, 1),
            Span(5, "herd", 60, 65, 1, 1)]
    got = {k: round(v * 1e9) for k, v in
           spans.idle_by_span(trace, made).items()}
    # idle (10, 30), (40, 70), (100, 110)
    assert got == {"solve": 17, "tick": 18, "drain": 7, "reset": 3,
                   "herd": 5, "none": 10}
    assert spans.ops_inside(trace, [made[3], made[4]]) == 0
    assert spans.ops_inside(trace, [made[0]]) == 2


def test_idle_unspanned_is_seconds_a_key(monkeypatch):
    trace = _trace((0, 10), (30, 40), (70, 100), (110, 120))
    made = [Span(1, "solve", 5, 50, None, 1),
            Span(2, "tick", 12, 50, 1, 1),
            Span(3, "drain", 20, 35, 2, 1),
            Span(4, "solve", 60, 115, None, 2),
            Span(5, "herd", 60, 65, 4, 2)]
    monkeypatch.setattr(spans, "recorded", lambda: (made, 0))
    monkeypatch.setattr(spans, "traced_passes",
                        lambda ctx: [spans.Call(made[:3]),
                                     spans.Call(made[3:])])
    got = _reader("idle_unspanned.batch").read({"trace": trace})
    # idle (10, 30), (40, 70), (100, 110): 10 + 25 + 10 ns under solve,
    # tick or none; 10 under drain and 5 under herd are explained
    assert round(got * 1e9 * 2) == 45


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "pb_test_" + name.replace(".", "_"),
        REPO / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NEW)
def test_reader_without_spans_gives_none(monkeypatch, name):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    ctx = {"run": None, "trace": _trace((0, 10), (20, 30)),
           "outcome": SimpleNamespace(program={
               "keys": [(0.1, 0.2, 3, 0.5)], "ticks": 3})}
    assert _reader(name).read(ctx) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("pbspans"), max_ticks=60)


@pytest.mark.parametrize("cell", sorted(SPAN_ONLY))
def test_traced_run_reads_the_spans(root, cell):
    rc, res, err = run_cell(root, cell, seed=2_147_483_777, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    for m in SPAN_ONLY[cell]:
        assert res["metrics"][m]["value"] > 0, m
    # the CPU trace holds no device operation: left out, never 0
    for m in TRACE_ONLY.get(cell, ()):
        assert m not in res["metrics"]
