"""The plain reference: its curve against the fixtures' known keys, its
jump table, herd and walk against the port's plain PyTorch walk at a
tiny size, its records against the port's table encoding, and the
benchmark's frozen arithmetic (IMAD need, percentile, rates)."""

import math

import numpy as np
import pytest

from pb_tiny import REPO
from portbench.drivers import batch
from portbench.reference import kangaroo as rk
from portbench.reference import secp256k1 as ec
from portbench.roofline import walk as roof

KNOWN = [("in32.txt", 0xB862A62E), ("in40.txt", 0xA1B2C3D4E5),
         ("in56.txt", 0x9FD2E30C451A6B), ("in64.txt", 0xCAFEBABE12345678)]


def _fixture_key(name):
    lines = [ln.strip() for ln in (REPO / "fixtures" / name).read_text()
             .splitlines() if ln.strip()]
    return int(lines[0], 16), int(lines[1], 16), lines[2].upper()


@pytest.mark.parametrize("name,priv", KNOWN)
def test_mul_g_gives_the_fixture_key(name, priv):
    start, end, pub = _fixture_key(name)
    assert start <= priv <= end
    pt = ec.mul_g(priv)
    assert ec.on_curve(pt)
    assert ec.compressed_hex(pt) == pub


def test_group_law():
    a, b = 0x1234567, 0xFEDCBA9876543210
    assert ec.add(ec.mul_g(a), ec.mul_g(b)) == ec.mul_g(a + b)
    assert ec.add(ec.mul_g(a), ec.neg(ec.mul_g(a))) is None
    assert ec.mul_g(ec.N) is None and ec.mul_g(ec.N + 1) == ec.G


def test_words_are_mt19937_init_genrand():
    # the first outputs of MT19937 seeded with init_genrand(5489), the
    # generator's published default
    assert list(rk.Words(5489).take(3)) == [3499211612, 581869302,
                                             3890346734]


def test_imad_need_and_bound():
    assert round(roof.imad_per_jump(1 << 22), 1) == 832.0
    assert round(roof.bound_s(1 << 22, (1 << 22) * 1024) * 1e3, 1) == 213.3
    assert roof.IMAD_PEAK == 16.75e12


def test_percentile_and_rates():
    walls = [float(v) for v in range(1, 51)]
    assert batch.percentile(walls, 0.8) == 40.0
    assert sum(1 for w in walls if w > batch.percentile(walls, 0.8)) == 10
    assert batch.percentile([3.0], 0.8) == 3.0
    assert batch.percentile([2.0, 1.0], 0.5) == 1.0
    keys, seeds = batch.key_set(0x8000000000, 0x17FFFFFFFFF, 64, 1010)
    assert len(keys) == len(seeds) == 65
    assert all(0x8000000000 <= k <= 0x17FFFFFFFFF for k in keys)
    assert (keys, seeds) == batch.key_set(0x8000000000, 0x17FFFFFFFFF, 64,
                                          1010)


@pytest.mark.parametrize("sym", [False, True])
def test_reference_walks_as_the_port(sym):
    """The port's plain walk (kangaroo_torch.ops.jump_ref) and herd, fed
    the same inputs, agree with the reference lane by lane."""
    torch = pytest.importorskip("torch")
    from kangaroo_torch.core import curve
    from kangaroo_torch.core.herd import create_herd
    from kangaroo_torch.core.jumptable import create_jump_table
    from kangaroo_torch.core.solver import KangarooSolver, SolverOptions
    from kangaroo_torch.core.config import ProblemConfig
    from kangaroo_torch.ops import jump_ref
    from kangaroo_torch.utils import rng

    start, end, priv = 0x8000000000, 0x17FFFFFFFFF, 0x123456789AB
    pub = ec.mul_g(priv)
    n, seed, steps, dp = 32, 91, 24, 3
    s = KangarooSolver(ProblemConfig(start, end, [curve.PointA(*pub)]),
                       SolverOptions(nb_kangaroo=n, device="cpu",
                                     symmetry=sym, quiet=True))
    s.init_search_key(0)
    px, py, d = create_herd(n, s.range_power, s.width_div2, s.key_to_search,
                            0, rng.MT19937(seed), device="cpu",
                            symmetry=sym)
    jt = create_jump_table(s.range_power, sym)
    out = jump_ref.jump_steps_with_dp(
        px, py, d, *[torch.from_numpy(a.astype(np.int32))
                     for a in jt.as_arrays()],
        jump_ref.dp_limb_masks(dp), nb_run=steps, slots=8, symmetry=sym)
    search = rk.Search(start, end, pub, sym)
    table = rk.jump_table(search.power, sym)
    assert table.dist == jt.distances
    lanes = rk.herd(search, seed, n, list(range(n)))

    def col(t, j):
        return sum(int(v) << (16 * i) for i, v in enumerate(t[:, j]))

    for j, ln in enumerate(lanes):
        assert (col(px, j), col(py, j) % ec.P, col(d, j)) == (
            ln.x, ln.y, ln.d)
    dps = rk.walk(lanes, steps, table, dp, sym)
    for j, ln in enumerate(lanes):
        assert (col(out[0], j), col(out[1], j) % ec.P, col(out[2], j)) == (
            ln.x, ln.y, ln.d)
    assert int(out[3].sum()) == len(dps) > 0
    # every record's x is that of the point its distance stands for
    for lane, _, x, dd in dps:
        h, x128, d128 = rk.record(search, x, dd, lane & 1)
        wild, pts = rk.record_points(search, d128)
        assert wild == lane & 1
        assert any(p[0] & ((1 << 128) - 1) == x128 for p in pts)


def test_records_match_the_port_encoding():
    from kangaroo_torch.core.hashtable import convert

    search = rk.Search(0x8000000000, 0x17FFFFFFFFF, ec.mul_g(5), False)
    for d, wild in ((12345, 0), (search.half - 7, 1), (search.half + 9, 1)):
        x = 0xABCDEF << 130 | 0x1234
        true = rk.true_distance(search, d, wild)
        assert rk.record(search, x, d, wild) == convert(x, true, wild)
    assert math.isclose(search.power, 40)
