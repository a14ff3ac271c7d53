"""KangarooSolver on four CPU shards against the benchmark's plain
reference walk (`portbench/reference`: Python integers and numpy's
MT19937, nothing of the port), and the spans and counters of that run.

The lanes checked sit at each shard's bounds (lo, lo + 1, hi - 1) and
in its interior: a lane offset or a tame/wild parity taken from the
local lane index would show there first.
"""

from collections import Counter

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from kangaroo_torch.core import curve  # noqa: E402
from kangaroo_torch.core.config import ProblemConfig  # noqa: E402
from kangaroo_torch.core.solver import KangarooSolver, SolverOptions  # noqa: E402
from kangaroo_torch.utils import spans  # noqa: E402
from portbench import compare  # noqa: E402
from portbench.reference import kangaroo as rk  # noqa: E402
from portbench.reference import secp256k1 as ec  # noqa: E402

START, END = 0x8000000000, 0x17FFFFFFFFF
KEY = 0xC3A5F00D1234
# shards of 63 lanes: odd, so that shards 1 and 3 start on a wild lane
SHARDS, LANES, DP, NB_RUN, TICKS, SEED = 4, 252, 4, 16, 4, 2_147_490_017
SHARD_SPANS = {"herd.kG", "compact.wait", "compact"}


@pytest.fixture(scope="module")
def run():
    """The herd made in one solve() call, then walked TICKS ticks in a
    second; each call's spans, and the lanes' start and end."""
    pub = ec.mul_g(KEY)
    s = KangarooSolver(
        ProblemConfig(START, END, [curve.PointA(*pub)]),
        SolverOptions(nb_kangaroo=LANES, dp_size=DP, nb_run=NB_RUN,
                      windows_per_tick=1, seed=SEED, device="cpu",
                      n_devices=SHARDS, quiet=True))
    assert len(s.shards) == SHARDS
    lanes = sorted({j for sh in s.shards for j in (
        sh.lo, sh.lo + 1, sh.hi - 1, (sh.lo + sh.hi) // 2)})
    s.solve(0, max_ticks=0)
    start = compare.read_lanes(s.last_state, lanes)
    items0, dup0 = s.hash_table.n_items(), s.stats.dup
    assert s.solve(0, max_ticks=TICKS) is None
    end = compare.read_lanes(s.last_state, lanes)
    calls = [[x for x in spans.recorded() if x.serial == n] for n in
             sorted({x.serial for x in spans.recorded()
                     if x.name == "solve"})[-2:]]
    return dict(solver=s, lanes=lanes, start=start, end=end, calls=calls,
                pub=pub, inserted=s.hash_table.n_items() - items0,
                dup=s.stats.dup - dup0)


def test_shard_bounds_walk_as_the_reference(run):
    s, lanes = run["solver"], run["lanes"]
    assert s.stats.dead == 0 and s.stats.ticks == TICKS
    search = rk.Search(START, END, run["pub"], False)
    ref_start, ref_end, dps = rk.herd_walk(
        (search, SEED, LANES, lanes, [TICKS * NB_RUN],
         rk.jump_table(search.power, False), DP))
    for j in lanes:
        assert run["start"][j] == ref_start[j], j
        assert run["end"][j] == ref_end[j], j
    # every DP a checked lane passed, with the reference's record
    table = compare.Table(s.hash_table.export_arrays())
    checked, missing = compare.missing_dps(search, dps, table)
    assert missing == 0 and checked == len(dps)
    assert {lane for lane, *_ in dps} & {sh.lo for sh in s.shards}


def test_shard_spans_are_tagged(run):
    herd_call, walk_call = run["calls"]
    kg = [x.shard for x in herd_call if x.name == "herd.kG"]
    assert sorted(kg) == list(range(SHARDS))
    ticks = Counter(x.parent for x in walk_call if x.name == "compact")
    # each drained tick (and the final drain) pulls every shard once
    assert len(ticks) == TICKS
    for name in ("compact.wait", "compact"):
        got = Counter((x.parent, x.shard) for x in walk_call
                      if x.name == name)
        assert set(got.values()) == {1}
        assert sorted(got) == sorted((p, i) for p in ticks
                                     for i in range(SHARDS))
    for x in herd_call + walk_call:
        if x.name not in SHARD_SPANS:
            assert x.shard is None, x


def test_dps_counter_is_the_tables_records(run):
    herd_call, walk_call = run["calls"]
    assert spans.counters(herd_call[0].serial) == {}
    dps = spans.counters(walk_call[0].serial)["dps"]
    assert dps > 0 and dps == run["inserted"] + run["dup"]


def test_recorder_counters_by_serial():
    rec = spans.Recorder(cap_serials=2)
    rec.count("n", 5)                  # no span open: serial 0
    with rec.span("a") as a:
        rec.count("n", 2)
        with rec.span("b", shard=3):
            rec.count("n", 3)
            rec.count("m", 1)
    with rec.span("c") as c:
        rec.count("n", 7)
    assert rec.counters(a.serial) == {"n": 5, "m": 1}
    assert rec.counters(c.serial) == {"n": 7}
    # the oldest serial beyond cap_serials is let go
    assert rec.counters(0) == {}
    got = {x.name: x for x in rec.recorded()}
    assert got["b"].shard == 3 and got["a"].shard is None
    # a span built without the field, positionally, has none
    assert spans.Span(1, "solve", 5, 95, None, 1).shard is None
