"""kangaroo_torch's span recorder (utils/spans.py) and the spans of
KangarooSolver.solve, on the CPU; on a card, that a span and the device
trace share one clock.

Imports only the port, so the card test runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_spans.py -m cuda -s
"""

import functools
import os
import threading
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from kangaroo_torch.core import curve, herd, solver  # noqa: E402
from kangaroo_torch.core.config import parse_config_file  # noqa: E402
from kangaroo_torch.core.jumptable import create_jump_table  # noqa: E402
from kangaroo_torch.ops import jump_cuda, jump_ref  # noqa: E402
from kangaroo_torch.utils import spans  # noqa: E402
from kangaroo_torch.utils.rng import MT19937  # noqa: E402

IN32 = os.path.join(os.path.dirname(__file__), "..", "fixtures", "in32.txt")

SOLVE_SPANS = {"solve", "jump_table", "herd", "herd.draws", "herd.kG",
               "tick", "compact.wait", "compact", "launch", "drain", "reset",
               "save", "finish", "sync"}


def test_recorder_parent_serial():
    rec = spans.Recorder()
    with rec.span("a") as a:
        with rec.span("b"):
            pass
        c = rec.add("c", 10, 20)
    with rec.span("d") as d:
        pass
    got = rec.recorded()
    # oldest closed first
    assert [s.name for s in got] == ["b", "c", "a", "d"]
    by = {s.name: s for s in got}
    assert by["b"].parent == by["c"].parent == a.id == by["a"].id
    assert by["a"].parent is None and by["d"].parent is None
    assert by["a"].serial == by["b"].serial == by["c"].serial == a.serial
    assert by["d"].serial == d.serial != a.serial
    assert c.seconds == 10e-9 and by["c"].start == 10
    assert by["a"].start <= by["b"].start <= by["b"].end <= by["a"].end
    assert by["a"].seconds == a.seconds and rec.dropped == 0


def test_recorder_memory_bounded():
    rec = spans.Recorder(cap=8)
    for i in range(20):
        with rec.span(f"s{i}"):
            pass
    got = rec.recorded()
    assert len(got) == 8 and rec.dropped == 12
    # the newest kept, the oldest dropped first
    assert [s.name for s in got] == [f"s{i}" for i in range(12, 20)]
    assert spans.CAP == 1 << 18


def test_recorder_threads_keep_their_own_parents():
    rec = spans.Recorder()
    seen = []

    def other():
        with rec.span("t") as t:
            seen.append(t)

    with rec.span("main") as m:
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    assert seen[0].parent is None and seen[0].serial != m.serial


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """A tiny solve with dead-lane resets and a save every tick (seed 13
    meets dead kangaroos in its first 8 ticks), then a second solve()
    of the same key, which continues the herd."""
    work = str(tmp_path_factory.mktemp("spans") / "s.work")
    s = solver.KangarooSolver(parse_config_file(IN32), solver.SolverOptions(
        nb_kangaroo=512, dp_size=4, nb_run=16, seed=13, device="cpu",
        quiet=True, work_file=work, save_period=0))
    res = s.solve(0, max_ticks=8)
    st = s.stats
    first = (res, st.ticks, st.herd_time, st.save_stall, st.save_wait,
             list(st.compact_s), st.time, st.count)
    s.solve(0, max_ticks=1)
    serials = sorted({x.serial for x in spans.recorded()
                      if x.name == "solve"})[-2:]
    calls = [[x for x in spans.recorded() if x.serial == n]
             for n in serials]
    return first, calls, s


def test_solve_records_each_span(solved):
    (res, ticks, *_), (call, _), _ = solved
    assert res is None and ticks == 8
    names = Counter(x.name for x in call)
    assert set(names) == SOLVE_SPANS
    # the final drain included
    assert names["tick"] == names["compact"] == names["drain"] == ticks
    assert names["compact.wait"] == names["launch"] == names["save"] == ticks
    assert names["solve"] == names["herd"] == names["finish"] == 1
    by_id = {x.id: x for x in call}
    parent = {x.name: by_id[x.parent].name for x in call if x.parent}
    assert parent["herd.draws"] == parent["herd.kG"] == "herd"
    assert parent["reset"] == "drain" and parent["sync"] == "finish"
    assert parent["launch"] == "tick" and parent["jump_table"] == "solve"
    assert {by_id[x.parent].name for x in call
            if x.name in ("compact", "drain")} == {"tick", "finish"}
    solve = next(x for x in call if x.name == "solve")
    assert all(solve.start <= x.start <= x.end <= solve.end for x in call)


def test_stats_timers_are_the_spans(solved):
    (_, _, herd_time, stall, wait, compact_s, loop_s, _), (call, _), _ = \
        solved
    named = {n: [x for x in call if x.name == n]
             for n in ("herd", "save", "save.wait", "compact",
                       "compact.wait", "sync")}
    assert herd_time == named["herd"][0].seconds
    # added up in call order, as SolveStats adds them (sum() of floats
    # compensates its rounding)
    assert stall == functools.reduce(
        lambda t, x: t + x.seconds, named["save"], 0.0)
    assert wait == functools.reduce(
        lambda t, x: t + x.seconds, named["save.wait"], 0.0)
    assert [sum(compact_s[i]) for i in range(len(compact_s))] == [
        (w.end - w.start + c.end - c.start) * 1e-9
        for w, c in zip(named["compact.wait"], named["compact"])]
    assert len(compact_s) == len(named["compact"])
    # the loop's seconds: its start, after the call's and before its
    # first tick's, to the end of the final synchronise
    solve = next(x for x in call if x.name == "solve")
    first_tick = min(x.start for x in call if x.name == "tick")
    end = named["sync"][0].end
    assert end - first_tick <= round(loop_s * 1e9) <= end - solve.start


def test_second_solve_gets_a_new_serial(solved):
    _, (first, second), s = solved
    assert first[0].serial != second[0].serial
    names = Counter(x.name for x in second)
    # the continued herd is restored, not drawn
    assert names["herd"] == 1 and "herd.draws" not in names
    assert names["tick"] == s.stats.ticks == 1


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_trace_clock():
    """A span around one walk launch and a synchronise holds the
    kernel's device interval as torch.profiler traces it with CUDA
    activity only (as portbench/trace.py runs it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernel has no CPU mode")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = torch.device("cuda", 0)
    rp, n = 64, 64 * jump_cuda.LANE_QUANTUM
    state = herd.create_herd(n, rp, ((1 << rp) - 1) >> 1,
                             curve.mul(0xDEADBEEF12345), 0, MT19937(3),
                             device=card)
    tabs = [torch.from_numpy(a.astype("int32")).to(card)
            for a in create_jump_table(rp).as_arrays()]
    masks = jump_ref.dp_limb_masks(16, card)

    def launch():
        return jump_cuda.jump_steps_with_dp(*[t.clone() for t in state],
                                            *tabs, masks, nb_run=256,
                                            slots=2)

    launch()  # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.span("clock") as sp:
            launch()
            torch.cuda.synchronize()
    kernels = [ev for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == DeviceType.CUDA
               and "kt_jump_kernel" in ev.name()]
    assert len(kernels) == 1
    start = int(kernels[0].start_ns())
    end = start + int(kernels[0].duration_ns())
    print(f"span {sp.start}..{sp.end} ns; kernel {start}..{end} ns: "
          f"starts {(start - sp.start) * 1e-3:.1f} us after the span, "
          f"ends {(sp.end - end) * 1e-3:.1f} us before its end")
    assert sp.start <= start < end <= sp.end
