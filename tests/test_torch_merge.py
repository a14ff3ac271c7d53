"""kangaroo_torch work-file merges and -winfo vs the JAX package, on the
CPU.

Tables of valid DPs (x of dist*G, or keyToSearch + dist*G for wild
ones) with overlaps, dead collisions and a solving tame/wild pair: the
port's merge_work, merge_dir and partitioned merges must write files
byte-equal to the JAX package's and report the same key and dead count;
-winfo text equal to JAX's for a file and a partition directory; the
hash-table helpers that the merge path shares.  Tolerance 0: file
bytes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kangaroo_tpu.io import backup as jbackup  # noqa: E402
from kangaroo_tpu.io import merge as jmerge  # noqa: E402
from kangaroo_torch import native  # noqa: E402
from kangaroo_torch.constants import N_ORDER  # noqa: E402
from kangaroo_torch.core import curve  # noqa: E402
from kangaroo_torch.core.hashtable import (  # noqa: E402
    calc_dist_and_type, convert, make_hash_table)
from kangaroo_torch.io import backup, merge  # noqa: E402
from kangaroo_torch.io.merge import WorkHeader, write_work_header  # noqa: E402

RANGE_START = 0x100000
RANGE_END = 0x1FFFFF
K_PRIV = 0x15A3B7  # inside [RANGE_START, RANGE_END]


def _key_to_search():
    return curve.add(curve.mul(K_PRIV), curve.mul(RANGE_START).neg())


def record(dist: int, ktype: int, d_stored=None) -> bytes:
    """A 36-byte table record of a valid DP (d_stored overrides the
    stored mod-n distance, for dead collisions)."""
    pt = curve.mul(dist)
    if ktype == 1:
        pt = curve.add(_key_to_search(), pt)
    h, x128, d128 = convert(pt.x, dist if d_stored is None else d_stored,
                            ktype)
    return (h.to_bytes(4, "little") + x128.to_bytes(16, "little")
            + d128.to_bytes(16, "little"))


def table(recs):
    t = make_hash_table()
    t.add_batch_raw(b"".join(recs), len(recs))
    return t


def save(path, t, count=100, time=1.0, dp=8, version=0):
    hdr = WorkHeader(dp, RANGE_START, RANGE_END, curve.mul(K_PRIV), count,
                     time, version)
    with open(path, "wb") as f:
        write_work_header(f, hdr)
        backup.write_hash_table(f, t)


def both(path_fn, port_call, jax_call):
    """Run one merge in the port and in the JAX package on copies of the
    same inputs; returns both results and both output directories."""
    out = []
    for who, call in (("t", port_call), ("j", jax_call)):
        d = path_fn(who)
        out.append((call(d), d))
    return out


def tree_bytes(d):
    return {os.path.relpath(os.path.join(r, f), d):
            open(os.path.join(r, f), "rb").read()
            for r, _, fs in os.walk(d) for f in fs}


def make_inputs(d):
    """Three work files: overlapping tame DPs, 70 dead collisions (more
    than the native pair buffer of 64), and different dp/count/time."""
    os.makedirs(d, exist_ok=True)
    save(os.path.join(d, "a.work"),
         table([record(v, v & 1) for v in range(1000, 1040)]), 10, 1.5, 9)
    save(os.path.join(d, "b.work"),
         table([record(v, v & 1) for v in range(1020, 1060)]
               + [record(v, 0, N_ORDER - v) for v in range(5000, 5070)]),
         20, 2.25, 8)
    save(os.path.join(d, "c.work"),
         table([record(v, 0) for v in range(5000, 5070)]), 5, 0.5, 10)


def test_merge_work_and_dir_equal_jax(tmp_path, capsys):
    def files(who):
        d = str(tmp_path / who)
        make_inputs(d)
        return d

    (tres, td), (jres, jd) = both(
        files,
        lambda d: merge.merge_work(os.path.join(d, "a.work"),
                                   os.path.join(d, "b.work"),
                                   os.path.join(d, "ab.work")),
        lambda d: jmerge.merge_work(os.path.join(d, "a.work"),
                                    os.path.join(d, "b.work"),
                                    os.path.join(d, "ab.work")))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "MergeWork: Done [130 DP][dead 20]"
    assert tres == jres == (True, None, 20)
    tres = merge.merge_work(os.path.join(td, "ab.work"),
                            os.path.join(td, "c.work"),
                            os.path.join(td, "abc.work"), verbose=False)
    jres = jmerge.merge_work(os.path.join(jd, "ab.work"),
                             os.path.join(jd, "c.work"),
                             os.path.join(jd, "abc.work"), verbose=False)
    assert tres == jres == (True, None, 70)  # 70 dead collisions
    for name in ("ab.work", "abc.work"):
        t = open(os.path.join(td, name), "rb").read()
        assert t == open(os.path.join(jd, name), "rb").read()
        assert backup.work_info(os.path.join(td, name)) == \
            jbackup.work_info(os.path.join(jd, name))
    lw = backup.load_work(os.path.join(td, "abc.work"))
    assert lw.hash_table.n_items() == 130 and lw.kangaroos is None
    assert (lw.dp_size, lw.count, lw.time) == (8, 35, 4.25)
    # merge_dir folds the directory, largest file first
    for who in ("t", "j"):
        for name in ("ab.work", "abc.work"):
            os.remove(str(tmp_path / who / name))
    tres = merge.merge_dir(str(td), str(tmp_path / "t.dir.work"))
    jres = jmerge.merge_dir(str(jd), str(tmp_path / "j.dir.work"))
    assert tres == jres == (True, None, 90)
    assert open(tmp_path / "t.dir.work", "rb").read() == \
        open(tmp_path / "j.dir.work", "rb").read()


def test_merge_solves_like_jax(tmp_path):
    """A tame and a wild DP on one point: the merge reports the key and
    writes no file, in both packages (plain and -sym headers)."""
    dist_t = 777777
    dist_w = (dist_t - (K_PRIV - RANGE_START)) % N_ORDER
    for version in (0, 1):
        d = tmp_path / f"v{version}"
        d.mkdir()
        f1, f2 = str(d / "a.work"), str(d / "b.work")
        save(f1, table([record(dist_t, 0)] + [record(v, 0)
                                               for v in range(10, 30)]),
             version=version)
        save(f2, table([record(dist_w, 1)]), version=version)
        t_ok, t_res, t_dead = merge.merge_work(f1, f2, str(d / "t.work"))
        j_ok, j_res, j_dead = jmerge.merge_work(f1, f2, str(d / "j.work"))
        assert (t_res is None) == (j_res is None)
        assert t_dead == j_dead
        if version == 0:
            assert t_res.private_key == j_res.private_key == K_PRIV
        else:  # the -sym key recentring: the JAX package's answer
            assert (t_res.private_key if t_res else None) == (
                j_res.private_key if j_res else None)
        assert not os.path.exists(d / "t.work") or t_res is None


def test_partitioned_merges_equal_jax(tmp_path):
    """-wpartcreate, a file into an empty and a full partition dir, a
    partition dir into another, -winfo and -wcheck's scan of them: the
    same bytes, counts and text as the JAX package."""
    src = str(tmp_path / "src")
    make_inputs(src)
    outs = {}
    for who, m in (("t", merge), ("j", jmerge)):
        d = str(tmp_path / who)
        os.makedirs(d)
        p1, p2 = os.path.join(d, "p1"), os.path.join(d, "p2")
        m.create_empty_part_work(p1)
        m.create_empty_part_work(p2)
        res = [m.merge_work_part(p1, os.path.join(src, "a.work")),
               m.merge_work_part(p1, os.path.join(src, "b.work")),
               m.merge_work_part(p2, os.path.join(src, "c.work")),
               m.merge_work_part_part(p2, p1, nb_thread=4)]
        outs[who] = (res, tree_bytes(d), p2)
    assert outs["t"][0] == outs["j"][0]
    assert outs["t"][1] == outs["j"][1]
    assert backup.work_info(outs["t"][2]) == jbackup.work_info(outs["j"][2])
    with pytest.raises(ValueError, match="exists"):
        merge.create_empty_part_work(outs["t"][2])
    with pytest.raises(ValueError, match="versions"):
        other = str(tmp_path / "sym.work")
        save(other, table([record(3, 1)]), version=1)
        merge.merge_work(os.path.join(src, "a.work"), other,
                         str(tmp_path / "x.work"))


def test_native_bindings_and_table_helpers(tmp_path):
    """scan/count over a bucket region, a table's region round trip and
    the helpers that copy the JAX table's interface."""
    recs = [record(v, v & 1) for v in range(200, 260)]
    t = table(recs)
    path = str(tmp_path / "w.work")
    save(path, t)
    nb, mx = native.scan_buckets(path, backup.HEADW_HEADER_SIZE, 1 << 18)
    assert int(nb.sum()) == 60 == native.count_buckets(
        path, backup.HEADW_HEADER_SIZE, 1 << 18)
    assert all(int(m) == backup.ref_max_item(int(n)) for n, m in zip(nb, mx))
    u = make_hash_table()
    assert u.read_region(path, backup.HEADW_HEADER_SIZE) == 8 * (1 << 18) \
        + 32 * 60
    assert u.export() == t.export()
    items = list(t.iter_sorted())
    assert len(items) == 60 and items == sorted(items)
    h, xlo, xhi, dlo, dhi = t.export_arrays()
    assert [(int(a), int(b) | int(c) << 64, int(e) | int(f) << 64)
            for a, b, c, e, f in zip(h, xlo, xhi, dlo, dhi)] == items
    for _, _, d128 in items[:5]:
        dist, ktype = calc_dist_and_type(d128)
        assert 200 <= dist < 260 and ktype == dist & 1
    v = make_hash_table()
    v.absorb(t)
    assert v.export() == t.export()
    n, lo, hi, avg = t.stats()
    assert (n, lo, avg) == (60, 1, 60 / (1 << 18)) and hi >= 1
    assert make_hash_table().stats() == (0, 0, 0, 0.0)
    with pytest.raises(IOError):
        native.scan_buckets(str(tmp_path / "missing"), 0, 4)
    np.testing.assert_array_equal(nb, jbackup._scan_bucket_counts(
        path, backup.HEADW_HEADER_SIZE, 1 << 18)[0])
