"""kangaroo_torch work files vs the JAX package, on the CPU.

Herd packing (plain and -sym, wild lanes at the width's edge), the
HEADW/HEADK/HEADKS writers (byte-equal to the JAX package's files for
the same table, herd, count and time, and each package reading the
other's files) and the HEADKS rebuild of positions from distances.
Integer data and file bytes: tolerance 0 throughout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

# the JAX solver's native table, loaded whatever the build race
pytestmark = pytest.mark.usefixtures("jax_native")

from kangaroo_tpu.core import curve as jcurve  # noqa: E402
from kangaroo_tpu.core import herd as jherd  # noqa: E402
from kangaroo_tpu.core.config import ProblemConfig as JConfig  # noqa: E402
from kangaroo_tpu.core.hashtable import NativeHashTable as JTable  # noqa: E402
from kangaroo_tpu.core.solver import KangarooSolver as JSolver  # noqa: E402
from kangaroo_tpu.core.solver import SolverOptions as JOptions  # noqa: E402
from kangaroo_tpu.io import backup as jbackup  # noqa: E402
from kangaroo_tpu.utils import packing as jpacking  # noqa: E402
from kangaroo_torch.constants import N_ORDER, P  # noqa: E402
from kangaroo_torch.core import curve  # noqa: E402
from kangaroo_torch.core.config import ProblemConfig  # noqa: E402
from kangaroo_torch.core.hashtable import NativeHashTable, convert  # noqa: E402
from kangaroo_torch.core.solver import KangarooSolver, SolverOptions  # noqa: E402
from kangaroo_torch.io import backup  # noqa: E402
from kangaroo_torch.utils import packing  # noqa: E402
from kangaroo_torch.utils.intutils import (  # noqa: E402
    ints_to_limbs_fast, limbs_to_ints_fast)

RANGE_START = 0x300000
RANGE_END = 0x3FFFFF
K_PRIV = 0x35A3B7
WD2 = (RANGE_END - RANGE_START) >> 1


def solvers(symmetry=False, dp=7):
    """A port and a JAX solver on the same range, key and DP size, ready
    to write headers (no walk)."""
    ts = KangarooSolver(
        ProblemConfig(RANGE_START, RANGE_END, [curve.mul(K_PRIV)]),
        SolverOptions(nb_kangaroo=16, device="cpu", quiet=True,
                      symmetry=symmetry))
    js = JSolver(JConfig(RANGE_START, RANGE_END, [jcurve.mul(K_PRIV)]),
                 JOptions(nb_kangaroo=16, n_devices=1, quiet=True,
                          symmetry=symmetry))
    for s in (ts, js):
        s.init_search_key(0)
        s.dp_size = dp
    return ts, js


def random_herd(n, symmetry, seed):
    """(px, py, d) uint32 limbs: px random, py relaxed (some >= p), d at
    the width's edges on wild lanes (W/2 +- 1, 0, 2^127 region for
    -sym's negative values) and random elsewhere."""
    rs = np.random.RandomState(seed)
    px = rs.randint(0, 1 << 16, (16, n)).astype(np.uint32)
    py = rs.randint(0, 1 << 16, (16, n)).astype(np.uint32)
    py[:, :4] = ints_to_limbs_fast([P, P + 5, (1 << 256) - 1, P - 1])
    if symmetry:
        vals = [rs.randint(0, 1 << 20) - (1 << 19) for _ in range(n)]
        vals[:6] = [0, -1, 1, WD2 >> 1, -(WD2 >> 1), -(WD2 >> 1) - 1]
    else:
        vals = [rs.randint(0, 1 << 22) for _ in range(n)]
        vals[1:8:2] = [WD2 - 1, WD2, WD2 + 1, 0]
    d = ints_to_limbs_fast([v & ((1 << 128) - 1) for v in vals], 8)
    return px, py, d


@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_pack_kangaroos_equals_jax(symmetry):
    px, py, d = random_herd(64, symmetry, 3)
    for first in (0, 1):
        buf = packing.pack_kangaroos(px, py, d, WD2, symmetry, first)
        assert buf == jpacking.pack_kangaroos(px, py, d, WD2, symmetry,
                                              first)
        got = packing.unpack_kangaroos(buf, WD2, symmetry, first)
        want = jpacking.unpack_kangaroos(buf, WD2, symmetry, first)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[0], px)
        np.testing.assert_array_equal(got[2], d)
        ys, cys = limbs_to_ints_fast(py), limbs_to_ints_fast(got[1])
        assert [int(y) % P for y in ys] == [int(y) for y in cys]
    # the vectorized distance transforms against the JAX scalar ones
    types = np.arange(64) & 1
    dm = packing.true_dist_limbs(d, types, WD2, symmetry)
    want = [jherd.true_distance(int(v), int(t), WD2, symmetry)
            for v, t in zip(limbs_to_ints_fast(d), types)]
    assert [int(v) for v in limbs_to_ints_fast(dm)] == want
    back = packing.device_dist_limbs(dm, types, WD2, symmetry)
    want = [jherd.device_distance(v, int(t), WD2, symmetry)
            for v, t in zip(want, types)]
    assert [int(v) for v in limbs_to_ints_fast(back)] == want


def test_d128_encoding_equals_jax():
    rs = np.random.RandomState(5)
    vals = [int(rs.randint(0, 1 << 30)) for _ in range(40)]
    vals += [(N_ORDER - v) % N_ORDER for v in vals[:20]] + [0]
    dm = ints_to_limbs_fast(vals)
    types = np.arange(len(vals)) & 1
    enc = packing.pack_d128(dm, types)
    np.testing.assert_array_equal(enc, jpacking.pack_d128(dm, types))
    want = [convert(0, v, int(t))[2] for v, t in zip(vals, types)]
    assert [int(v) for v in limbs_to_ints_fast(enc)] == want
    for a, b in zip(packing.unpack_d128(enc), jpacking.unpack_d128(enc)):
        np.testing.assert_array_equal(a, b)


def fill_tables(n=300, seed=7):
    """The same records (buckets spread, a few sharing one) in a port
    and a JAX native table."""
    rs = np.random.RandomState(seed)
    rec = rs.randint(0, 256, (n, 36)).astype(np.uint8)
    h = rs.randint(0, 1 << 18, n).astype("<u4")
    h[:20] = 77  # one bucket past the reference's 16-slot allocation
    rec[:, 0:4] = h.view(np.uint8).reshape(n, 4)
    t, j = NativeHashTable(), JTable()
    t.add_batch_raw(rec.tobytes(), n)
    j.add_batch_raw(rec.tobytes(), n)
    assert t.export() == j._export()
    return t, j


@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_save_work_bytes_equal_jax_and_cross_load(tmp_path, symmetry):
    ts, js = solvers(symmetry)
    ts.hash_table, js.hash_table = fill_tables()
    px, py, d = random_herd(32, symmetry, 11)
    tp, jp = str(tmp_path / "t.work"), str(tmp_path / "j.work")
    backup.save_work(tp, ts, torch.from_numpy(px.astype(np.int32)),
                     py, d, 123456789, 42.5, save_kangaroo=True)
    jbackup.save_work(jp, js, px, py, d, 123456789, 42.5,
                      save_kangaroo=True)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    lt = backup.load_work(jp)          # the port reads the JAX file
    lj = jbackup.load_work(tp, native=True)  # and the JAX package the port's
    assert lt.hash_table.export() == lj.hash_table._export()
    assert lt.symmetry == lj.symmetry == symmetry
    assert (lt.count, lt.time, lt.dp_size, lt.nb_kangaroo) == (
        lj.count, lj.time, lj.dp_size, lj.nb_kangaroo)
    for a, b in zip(lt.kangaroos, lj.kangaroos):
        np.testing.assert_array_equal(a, b)
    # table only: no kangaroos after the table
    backup.save_work(tp, ts, None, None, None, 5, 1.0)
    jbackup.save_work(jp, js, None, None, None, 5, 1.0)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert backup.load_work(tp).kangaroos is None


def test_write_hash_table_merge_style_equals_jax(tmp_path):
    t, j = fill_tables(50, seed=9)
    for style_t, style_j, name in (
            (backup.ref_max_item, jbackup.ref_max_item, "ref"),
            (backup.merge_max_item, jbackup.merge_max_item, "merge")):
        tp, jp = str(tmp_path / f"t.{name}"), str(tmp_path / f"j.{name}")
        with open(tp, "wb") as f:
            f.write(b"\x01" * 10)
            backup.write_hash_table(f, t, style_t)
            f.write(b"\x02")
        with open(jp, "wb") as f:
            f.write(b"\x01" * 10)
            jbackup.write_hash_table(f, j, style_j)
            f.write(b"\x02")
        assert open(tp, "rb").read() == open(jp, "rb").read()
    for nb in range(40):
        assert backup.ref_max_item(nb) == jbackup.ref_max_item(nb)
        assert backup.merge_max_item(nb) == jbackup.merge_max_item(nb)


@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_kangaroo_files_equal_jax(tmp_path, symmetry):
    """HEADK and HEADKS written byte-equal and read by both packages; the
    HEADKS rebuild (positions from distances) equal to JAX's."""
    ts, js = solvers(symmetry)
    from kangaroo_torch.core import herd
    from kangaroo_torch.utils.rng import MT19937

    px, py, d = (t.numpy().astype(np.uint32) for t in herd.create_herd(
        16, ts.range_power, WD2, ts.key_to_search, 0, MT19937(4),
        device="cpu", symmetry=symmetry))
    for compressed in (False, True):
        tp, jp = str(tmp_path / "t.kang"), str(tmp_path / "j.kang")
        backup.save_kangaroo_file(tp, ts, px, py, d, 100, 1.0, compressed)
        jbackup.save_kangaroo_file(jp, js, px, py, d, 100, 1.0, compressed)
        assert open(tp, "rb").read() == open(jp, "rb").read()
        got = backup.load_kangaroo_file(jp, RANGE_START, RANGE_END,
                                        ts.key_to_search, symmetry, "cpu")
        want = jbackup.load_kangaroo_file(tp, RANGE_START, RANGE_END,
                                          js.key_to_search, symmetry)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        # a fresh herd's state is fully determined by its distances,
        # but for -sym wild lanes, whose class flip took the -key branch
        # (the rebuild restarts them on +key, like the reference)
        lanes = slice(0, None, 2 if symmetry and compressed else 1)
        for a, b in zip(got, (px, py, d)):
            np.testing.assert_array_equal(a[:, lanes], b[:, lanes])
        with pytest.raises(ValueError, match="-sym"):
            backup.load_kangaroo_file(tp, RANGE_START, RANGE_END,
                                      ts.key_to_search, not symmetry, "cpu")


@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_rebuild_from_d128_equals_jax(symmetry):
    """Walked-looking distances (both signs, zero, large magnitudes,
    both types): the same positions, normalized classes and device
    distances as the JAX rebuild."""
    ts, js = solvers(symmetry)
    rs = np.random.RandomState(8)
    vals = [int(rs.randint(1, 1 << 30)) * (1 << int(rs.randint(0, 90)))
            for _ in range(30)]
    vals = [v % N_ORDER for v in vals]
    vals += [(N_ORDER - v) % N_ORDER for v in vals[:14]] + [0, 0, 1, 2]
    d128 = [convert(0, v, i & 1)[2] for i, v in enumerate(vals)]
    got = backup.rebuild_from_d128(d128, RANGE_START, RANGE_END,
                                   ts.key_to_search, symmetry, "cpu")
    want = jbackup.rebuild_from_d128(d128, RANGE_START, RANGE_END,
                                     js.key_to_search, symmetry)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    if symmetry:
        assert all(int(y) <= P >> 1 for y in limbs_to_ints_fast(got[1]))


def test_helpers_equal_jax():
    for s in (0, 59, 61, 3599, 3601, 86399, 86400 * 3, 86400 * 400,
              86400 * 365 * 7):
        assert backup.get_time_str(s) == jbackup.get_time_str(s)
    assert backup.SYM_VERSION == jbackup.SYM_VERSION
