"""The DP compaction kernels (ops/compact_cuda.py, csrc/compact.cuh,
csrc/compact_kernel.cu) against their plain version.

On the CPU the kernels' own body, built by g++ (ops/host_kernel.py),
is held bit for bit against `compact_cuda.compact_plain` on random
windows: one and two windows, more windows than one launch takes,
counts over the slots (the exact lost count), a tick with no DP, a
shard whose first lane is not 0, and the spill, where a block of small
capacity takes the first records and the rest is gathered again.  On a
card (`cuda`-marked; imports only the port, so it runs there with
`python -m pytest --noconftest tests/test_torch_compact_kernel.py -m
cuda`) the kernels themselves at each benchmark cell's shape, two
ticks in flight on one shard's blocks, and a two-shard solve against
the plain path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from kangaroo_torch.ops import compact_cuda, host_kernel  # noqa: E402


def windows(n, slots, count, lam, seed, device="cpu"):
    """`count` windows of n lanes and `slots` slots: DP counts drawn
    from Poisson(lam) (lam None: none), payload rows of random 16-bit
    limbs and steps."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        c = (np.zeros(n) if lam is None else rs.poisson(lam, n))
        arrays = (c.astype(np.int32),
                  rs.randint(0, 1 << 16, (slots, 10, n)).astype(np.int32),
                  rs.randint(0, 1 << 16, (slots, 8, n)).astype(np.int32),
                  rs.randint(0, 1 << 10, (slots, n)).astype(np.int32))
        out.append(tuple(torch.from_numpy(a).to(device) for a in arrays))
    return out


# (n, slots, windows, Poisson rate a lane, nb_run, lo, capacity)
CASES = {
    "one_window": (2100, 3, 1, 0.8, 16, 0, None),
    "two_windows": (3000, 2, 2, 0.5, 64, 0, None),
    "over_slots": (1500, 2, 2, 6.0, 256, 0, None),
    "no_dp": (1024, 4, 2, None, 16, 0, None),
    "shard_lo": (777, 3, 1, 1.0, 16, 3 << 22, None),
    "more_windows_than_a_launch": (40, 2, 66, 0.7, 4, 8192, None),
    "spill": (2100, 3, 2, 0.8, 16, 1 << 20, 37),
    "spill_everything": (600, 2, 1, 0.9, 16, 0, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_kernel_matches_plain(case):
    """The kernels' body on the host gives the plain version's lost
    count and block bit for bit; the header's m equals the records."""
    n, slots, count, lam, nb_run, lo, cap = CASES[case]
    wins = windows(n, slots, count, lam, seed=n + count)
    lost, blk = compact_cuda.compact_plain(wins, slots, nb_run, lo)
    got_lost, got = host_kernel.compact(wins, slots, nb_run, lo, cap)
    assert got_lost == lost
    assert got.dtype == blk.dtype == np.int32
    assert got.shape == blk.shape and np.array_equal(got, blk)
    counts = np.stack([w[0].numpy() for w in wins])
    assert lost == int((counts - np.minimum(counts, slots)).sum())
    assert len(blk) == int(np.minimum(counts, slots).sum())
    if case == "over_slots":
        assert lost > 0
    if case == "no_dp":
        assert lost == 0 and blk.shape == (0, 20)
    if cap is not None:
        assert len(blk) > cap  # the spill ran


def test_capacity_follows_the_shape():
    """The pinned block's records: the expected DPs and a margin of 8
    standard deviations and 64, never above the slot cells."""
    e = 8192 * 4 / 16
    assert compact_cuda.capacity(8192, 4, 1, 4, 6) == int(
        np.ceil(e + 8 * np.sqrt(e) + 64))
    assert compact_cuda.capacity(1 << 22, 1024, 1, 16, 4) == 65536 + 2048 + 64
    assert compact_cuda.capacity(16, 1024, 2, 2, 3) == 3 * 16 * 2


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the compaction kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


# (n, slots, windows, nb_run, dp) of each cell's tick, and of -nwin 2
CARD_SHAPES = {
    "batch40": (8192, 6, 1, 4, 4),
    "puzzle85": (1 << 22, 4, 1, 1024, 16),
    "nwin2": (1 << 20, 4, 2, 512, 14),
    "66_windows": (8192, 2, 66, 8, 6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernel_matches_plain_on_card(card, shape):
    """One queue on a stream, read after its event: bit-equal to the
    plain version on the same card tensors, one launch; and once more
    through blocks of capacity 5, which spill."""
    n, slots, count, nb_run, dp = CARD_SHAPES[shape]
    wins = windows(n, slots, count, nb_run / float(1 << dp), seed=n,
                   device=card)
    want = compact_cuda.compact_plain(wins, slots, nb_run, 8192)
    for cap in (compact_cuda.capacity(n, nb_run, count, dp, slots), 5):
        blocks = compact_cuda.Blocks(card, n, slots, count, cap)
        launches = compact_cuda.LAUNCHES
        q = blocks.queue(wins, slots, nb_run, 8192)
        torch.cuda.current_stream(card).record_event().synchronize()
        lost, blk = q.read()
        assert compact_cuda.LAUNCHES == launches + 1
        assert q.spilled == (len(want[1]) > cap)
        assert lost == want[0] and np.array_equal(blk, want[1]), cap


@pytest.mark.cuda
def test_two_ticks_in_flight_stay_intact(card):
    """Tick T+1 queued on the shard's blocks before tick T is read (the
    solver reads T while T+1 runs): both read back as their plain
    versions, each from its own pinned block."""
    n, slots, nb_run, dp = CARD_SHAPES["batch40"][0], 6, 4, 4
    blocks = compact_cuda.Blocks(
        card, n, slots, 1, compact_cuda.capacity(n, nb_run, 1, dp, slots))
    ticks = [windows(n, slots, 1, 0.25, seed=s, device=card) for s in (1, 2)]
    want = [compact_cuda.compact_plain(w, slots, nb_run) for w in ticks]
    first = blocks.queue(ticks[0], slots, nb_run)
    torch.cuda.current_stream(card).record_event().synchronize()
    a = first.read()
    second = blocks.queue(ticks[1], slots, nb_run)
    torch.cuda.current_stream(card).record_event().synchronize()
    b = second.read()
    assert a[0] == want[0][0] and np.array_equal(a[1], want[0][1])
    assert b[0] == want[1][0] and np.array_equal(b[1], want[1][1])
    assert not np.array_equal(a[1], b[1])


@pytest.mark.cuda
def test_two_shard_solve_matches_the_plain_path(card, monkeypatch):
    """A solve over two shards of one card fills the same table as the
    same solve with the plain compaction, with one kernel call a shard
    and tick."""
    from kangaroo_torch.core import curve
    from kangaroo_torch.core.config import ProblemConfig
    from kangaroo_torch.core.solver import KangarooSolver, SolverOptions
    from kangaroo_torch.parallel import sharding

    start = 0xB0_0000_0000
    cfg = ProblemConfig(start, start + (1 << 40) - 1,
                        [curve.mul(start + 0x1234567891)])

    def solve():
        s = KangarooSolver(cfg, SolverOptions(
            nb_kangaroo=2 * 8192, dp_size=4, nb_run=4, seed=11, quiet=True,
            device=[str(card), str(card)]))
        s.solve(0, max_ticks=12)
        return s

    launches = compact_cuda.LAUNCHES
    got = solve()
    assert compact_cuda.LAUNCHES - launches == got.stats.ticks * 2

    def plain(sh, wins, slots, nb_run):
        # the CPU's pull of a card's windows: its read, compact_plain,
        # runs on the reader thread's stream, so the windows end first
        sh.stream.synchronize()
        return compact_cuda.Plain(wins, slots, nb_run, sh.lo)

    monkeypatch.setattr(sharding, "queue_compact", plain)
    want = solve()
    assert got.hash_table.n_items() > 1000
    assert got.hash_table.export() == want.hash_table.export()
    assert (got.stats.dead, got.stats.lost, got.stats.count) == (
        want.stats.dead, want.stats.lost, want.stats.count)
