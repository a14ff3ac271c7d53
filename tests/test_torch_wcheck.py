"""kangaroo_torch -wcheck vs the JAX package, on the CPU.

check_work_file and check_partitioned must count the same DPs and the
same wrong ones as the JAX package's on a valid file, a corrupted one
(a distance, an x and a bucket changed), -sym files (a wild DP is valid
on either branch of P = +-key + d*G, a plain header refuses the other
branch) and a partition directory, at any batch size.  Tolerance 0:
integer counts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from kangaroo_tpu.core import check as jcheck  # noqa: E402
from kangaroo_torch.constants import N_ORDER  # noqa: E402
from kangaroo_torch.core import check, curve  # noqa: E402
from kangaroo_torch.core.config import ProblemConfig  # noqa: E402
from kangaroo_torch.core.hashtable import convert, make_hash_table  # noqa: E402
from kangaroo_torch.core.solver import KangarooSolver, SolverOptions  # noqa: E402
from kangaroo_torch.io import backup, merge  # noqa: E402
from kangaroo_torch.io.merge import WorkHeader, write_work_header  # noqa: E402

RANGE_START = 0x200000
RANGE_END = 0x2FFFFF
K_PRIV = 0x25A3B7
# every file holds N DPs: the JAX check compiles its k*G per batch size
N = 48


def key_to_search(symmetry):
    sp = RANGE_START + (((RANGE_END - RANGE_START) >> 1) if symmetry else 0)
    return curve.add(curve.mul(K_PRIV), curve.mul(sp).neg())


def records(symmetry=False, other_branch=False):
    """N valid DPs: tame and wild, positive and negative (n - d)
    distances; with other_branch, odd wild DPs sit on keyToSearch - d*G
    (valid only in a -sym file)."""
    key = key_to_search(symmetry)
    out = []
    for i in range(N):
        dist = 1000 + 37 * i
        if i % 3 == 2:
            dist = N_ORDER - dist  # a "negative" distance
        ktype = (i >> 1) & 1
        pt = curve.mul(dist)
        if ktype == 1:
            if other_branch and i & 1:
                pt = curve.add(key, pt.neg())
            else:
                pt = curve.add(key, pt)
        out.append(convert(pt.x, dist, ktype))
    return out


def save(path, recs, symmetry=False):
    t = make_hash_table()
    t.add_batch_raw(b"".join(h.to_bytes(4, "little")
                             + x.to_bytes(16, "little")
                             + d.to_bytes(16, "little") for h, x, d in recs),
                    len(recs))
    hdr = WorkHeader(8, RANGE_START, RANGE_END, curve.mul(K_PRIV), 10, 1.0,
                     backup.SYM_VERSION if symmetry else 0)
    with open(path, "wb") as f:
        write_work_header(f, hdr)
        backup.write_hash_table(f, t)
    return path


def counts(path, batch=check.WCHECK_BATCH):
    """(n_items, n_wrong) of the port's check, asserted equal to the JAX
    package's (about 8 s a call on the CPU: at most three per file)."""
    rep = check.check_work_file(path, batch=batch, device="cpu")
    jrep = jcheck.check_work_file(path)
    assert (rep.n_items, rep.n_wrong) == (jrep.n_items, jrep.n_wrong)
    assert rep.ok == jrep.ok
    return rep.n_items, rep.n_wrong


def port_counts(path, batch=check.WCHECK_BATCH):
    rep = check.check_work_file(path, batch=batch, device="cpu")
    return rep.n_items, rep.n_wrong


def corrupted(recs):
    bad = list(recs)
    h, x, d = bad[0]
    bad[0] = (h, x, d ^ 0xFFFF)                  # a distance
    h, x, d = bad[4]
    bad[4] = (h, x ^ (1 << 100), d)              # the low 128 bits of x
    h, x, d = bad[7]
    bad[7] = ((h + 1) & ((1 << 18) - 1), x, d)   # the bucket
    return bad


def test_wcheck_files_and_partitions_equal_jax(tmp_path):
    """A corrupted file, then the same DPs valid, as a file and as a
    partition directory, at several batch sizes."""
    recs = records()
    bad = save(str(tmp_path / "bad.work"), corrupted(recs))
    assert counts(bad) == (N, 3)
    assert port_counts(bad, batch=7) == (N, 3)  # many batches
    good = save(str(tmp_path / "good.work"), recs)
    part = str(tmp_path / "parts")
    merge.create_empty_part_work(part)
    merge.merge_work_part(part, good)
    for batch in (check.WCHECK_BATCH, 5):
        assert port_counts(good, batch) == port_counts(part, batch) == (N, 0)
    rep = check.check_partitioned(part, device="cpu")
    assert (rep.n_items, rep.n_wrong, rep.ok) == (N, 0, True)
    bad_part = str(tmp_path / "bad_parts")
    merge.create_empty_part_work(bad_part)
    merge.merge_work_part(bad_part, bad)
    assert port_counts(bad_part) == (N, 3)


def test_wcheck_symmetry_files_equal_jax(tmp_path):
    both = records(symmetry=True, other_branch=True)
    assert counts(save(str(tmp_path / "sym.work"), both, True)) == (N, 0)
    # the same DPs under a plain header: the key is not recentred and the
    # other branch is not accepted
    n, wrong = counts(save(str(tmp_path / "plain.work"), both))
    assert n == N and wrong > 0
    # a -sym solve's own table
    cfg = ProblemConfig(0x40000, 0x40000 + (1 << 16) - 1,
                        [curve.mul(0x40000 + 0xBEE)])
    s = KangarooSolver(cfg, SolverOptions(
        nb_kangaroo=64, dp_size=1, nb_run=8, seed=5, symmetry=True,
        device="cpu", quiet=True))
    s.solve(0, max_ticks=4)
    wf = str(tmp_path / "solved.work")
    backup.save_work(wf, s, None, None, None, s.stats.count, 1.0)
    rep = check.check_work_file(wf, device="cpu")
    assert rep.n_items == s.hash_table.n_items() > 0 and rep.n_wrong == 0


def test_check_batch_any_width():
    """A batch of any width (here 201 = 3 x 67: its fold tree would
    leave 201 lanes for the host to invert one by one) is padded for the
    inversion: the same inverses mod p, and every valid DP checks."""
    from kangaroo_torch.constants import P
    from kangaroo_torch.ops import ec
    from kangaroo_torch.utils.intutils import (ints_to_limbs_fast,
                                               limbs_to_ints_fast)

    vals = [(7 ** i + 3) % P for i in range(201)]
    a = torch.from_numpy(ints_to_limbs_fast(vals).astype("int32"))
    got = limbs_to_ints_fast(ec._batch_inv(a).numpy().astype("uint32"))
    assert [int(g) % P for g in got] == [pow(v, -1, P) for v in vals]
    recs = (records() * 5)[:201]
    h = np.array([r[0] for r in recs], dtype=np.uint32)
    xw = np.array([[r[1] & (2 ** 64 - 1), r[1] >> 64] for r in recs],
                  dtype=np.uint64)
    dw = np.array([[r[2] & (2 ** 64 - 1), r[2] >> 64] for r in recs],
                  dtype=np.uint64)
    wrong = check._check_batch(h, xw, dw, key_to_search(False), False, "cpu")
    assert wrong.shape == (201,) and not wrong.any()
    dw[5, 0] ^= np.uint64(1)
    assert check._check_batch(h, xw, dw, key_to_search(False), False,
                              "cpu").tolist() == [i == 5 for i in range(201)]
