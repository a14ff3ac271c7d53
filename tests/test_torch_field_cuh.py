"""The walk kernel's own arithmetic and per-thread body, built by g++.

csrc/field.cuh and csrc/walk.cuh are the code nvcc compiles into the
CUDA walk kernel; csrc/host_shim.cpp exposes them through a plain C
interface, so here g++ builds the very same code for the CPU
(ops/host_kernel.py builds and binds it).  The field
ops are held against Python ints (the safegcd inversion also against the
JAX package's modinv), and the kernel body, run thread by thread on the
host at the kernel's real geometry, against the JAX package's reference walk and the port's plain walk on
the same inputs (bit-equal px, d, count and DP slots, py equal mod p),
in plain and in symmetry mode (there also symclass, and py canonical).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kangaroo_tpu.core import curve as jcurve, herd as jherd  # noqa: E402
from kangaroo_tpu.core.jumptable import create_jump_table  # noqa: E402
from kangaroo_tpu.ops import field as jfield  # noqa: E402
from kangaroo_tpu.ops import jump_ref as jref  # noqa: E402
from kangaroo_tpu.utils.rng import MT19937  # noqa: E402
from kangaroo_torch import interop  # noqa: E402
from kangaroo_torch.constants import P  # noqa: E402
from kangaroo_torch.ops import (  # noqa: E402
    field, host_kernel, jump_cuda, jump_ref, probe_cuda)
from tests import carry_cases as cc  # noqa: E402

RS = np.random.RandomState(0xC0DE)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: cannot build csrc/ for the host")
    return host_kernel.load()


def words(vals, nw=8):
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]
                     for v in vals], dtype=np.uint32)


def unwords(a):
    return [sum(int(r[i]) << (32 * i) for i in range(a.shape[1])) for r in a]


def operands():
    edge = [0, 1, 977, (1 << 32) + 977, P - 1, P, P + 1, (1 << 256) - 1,
            (1 << 256) - 2, 1 << 255, (1 << 32) - 1, 1 << 224]
    rnd = [int.from_bytes(RS.bytes(32), "little") for _ in range(1500)]
    a = rnd + edge * len(edge)
    b = rnd[::-1] + [e for e in edge for _ in edge]
    return a, b


@pytest.mark.parametrize("name,op", [
    ("kt_fe_add_n", lambda x, y: x + y),
    ("kt_fe_sub_n", lambda x, y: x - y),
    ("kt_fe_mul_n", lambda x, y: x * y),
])
def test_binary_ops(lib, name, op):
    a, b = operands()
    r = np.zeros((len(a), 8), np.uint32)
    wa, wb = words(a), words(b)  # referenced until the call returns
    getattr(lib, name)(r.ctypes.data, wa.ctypes.data, wb.ctypes.data, len(a))
    got = unwords(r)
    assert all(g < (1 << 256) for g in got)
    assert all((g - op(x, y)) % P == 0 for g, x, y in zip(got, a, b))


K1C = (1 << 32) + 977
M256 = (1 << 256) - 1
# words that make carries and borrows run: 0, 1 and the top two values
RUN_WORDS = (0, 1, 0xFFFFFFFE, 0xFFFFFFFF)


def run_pattern_values(count):
    """Values whose 32-bit words are drawn from RUN_WORDS."""
    w = RS.choice(len(RUN_WORDS), (count, 8))
    return [sum(RUN_WORDS[j] << (32 * i) for i, j in enumerate(row))
            for row in w]


def test_fe_fold_both_passes(lib):
    """fe_fold(r, k) for k over 0 .. 2^34 - 1 against ints: r near 2^256
    - 1 so that the first pass carries out of 2^256 and the second runs,
    including second passes that carry from word 1 into word 2 (the low
    part after a carry out reaches 2^67)."""
    ks = [0, 1, 2, 977, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 1 << 33,
          3 << 32, (1 << 34) - 2, (1 << 34) - 1]
    ks += [int(v) for v in RS.randint(0, 1 << 62, 400, dtype=np.int64)
           % (1 << 34)]
    rs, kk = [], []
    for k in ks:
        for r in (M256, M256 - 1, M256 - k * K1C + 1, 0, 1 << 255):
            rs.append(r % (1 << 256))
            kk.append(k)
        # first pass wraps to a low part whose words 0 and 1 are all
        # ones, where k * K1C >= 2^64 allows it: the second pass carries
        # into word 2
        if k * K1C >= 1 << 64:
            rs.append((1 << 256) + (1 << 64) - 1 - k * K1C)
            kk.append(k)
    rs += [int.from_bytes(RS.bytes(32), "little") for _ in range(400)]
    kk += [int(v) for v in RS.randint(0, 1 << 62, 400, dtype=np.int64)
           % (1 << 34)]
    wr = words(rs)
    wk = np.array(kk, dtype=np.uint64)
    lib.kt_fe_fold_n(wr.ctypes.data, wk.ctypes.data, len(rs))
    got = unwords(wr)
    assert all(g < (1 << 256) for g in got)
    assert all((g - r - k * (1 << 256)) % P == 0
               for g, r, k in zip(got, rs, kk))
    # the cases cover both passes and a second pass past word 1
    low = [r + k * K1C - (1 << 256) for r, k in zip(rs, kk)]
    assert sum(v >= 0 for v in low) > 100
    assert any(v >= 0 and (v & ((1 << 64) - 1)) + K1C >= 1 << 64
               for v in low)


def test_fe_sub_both_corrections(lib):
    """fe_sub against ints where b - a > p (the first correction borrows
    again, so the second runs), where the borrow runs through all 8 words
    (of the difference and of the first correction), and on operands
    whose words are 0, 1, 2^32 - 2 and 2^32 - 1."""
    edge = [(0, M256), (0, P + 1), (5, P + 6), (0, M256 - 4), (0, 1),
            (1 << 224, 1), (1, 1 << 255), (P, M256)]
    edge += [(j, M256 - j) for j in range(0, 1 << 33, 1 << 28)]
    a = [x for x, _ in edge] + run_pattern_values(3000)
    b = [y for _, y in edge] + run_pattern_values(3000)
    r = np.zeros((len(a), 8), np.uint32)
    wa, wb = words(a), words(b)
    lib.kt_fe_sub_n(r.ctypes.data, wa.ctypes.data, wb.ctypes.data, len(a))
    got = unwords(r)
    assert all(g < (1 << 256) for g in got)
    assert all((g - x + y) % P == 0 for g, x, y in zip(got, a, b))
    # coverage: both corrections, and a borrow out of every word of the
    # difference and of the first correction
    assert sum(y - x > P for x, y in zip(a, b)) > 10
    assert any(all(x % (1 << (32 * w)) < y % (1 << (32 * w))
                   for w in range(1, 9)) for x, y in zip(a, b))
    assert any(0 <= x - y + (1 << 256) < K1C
               and ((x - y + (1 << 256)) >> 64) == 0 for x, y in zip(a, b))


def test_fe_add_carry_out(lib):
    """fe_add against ints where a + b carries out of 2^256, and where
    the folded carry carries out again (a + b >= 2^257 - K1C)."""
    edge = [(M256, 1), (M256, M256), (M256, K1C - 1), (M256, K1C),
            (1 << 255, 1 << 255), (P, P), (M256 - 976, 977)]
    a = [x for x, _ in edge] + run_pattern_values(3000)
    b = [y for _, y in edge] + run_pattern_values(3000)
    r = np.zeros((len(a), 8), np.uint32)
    wa, wb = words(a), words(b)
    lib.kt_fe_add_n(r.ctypes.data, wa.ctypes.data, wb.ctypes.data, len(a))
    got = unwords(r)
    assert all(g < (1 << 256) for g in got)
    assert all((g - x - y) % P == 0 for g, x, y in zip(got, a, b))
    assert sum(x + y >= 1 << 256 for x, y in zip(a, b)) > 100
    assert any(x + y >= (1 << 257) - K1C for x, y in zip(a, b))


@pytest.mark.parametrize("name,jax_fn", [("kt_fe_add_n", "addmod"),
                                         ("kt_fe_sub_n", "submod")])
def test_add_sub_match_jax(lib, name, jax_fn):
    """The carry-chain fe_add and fe_sub against the JAX package's addmod
    and submod on the same inputs (the corner cases above, run-pattern
    words and random values; 16-bit limbs on the JAX side), compared
    canonical: bit-equal."""
    a, b = operands()
    a += [M256, M256, 0, 0, 5, 1 << 224] + run_pattern_values(1000)
    b += [1, M256, M256, 1, P + 6, 1] + run_pattern_values(1000)
    r = np.zeros((len(a), 8), np.uint32)
    wa, wb = words(a), words(b)
    getattr(lib, name)(r.ctypes.data, wa.ctypes.data, wb.ctypes.data,
                       len(a))

    def limbs(w):
        out = np.empty((16, w.shape[0]), np.uint32)
        out[0::2], out[1::2] = (w & 0xFFFF).T, (w >> 16).T
        return jnp.asarray(out)

    got = np.asarray(jax.jit(getattr(jfield, jax_fn))(limbs(wa), limbs(wb)))
    want = unwords(np.ascontiguousarray((got[0::2] | (got[1::2] << 16)).T))
    assert [g % P for g in unwords(r)] == [w % P for w in want]


CARRY_OPS = ("add_cc", "addc_cc", "addc", "sub_cc", "subc_cc", "subc")


def carry_op(op, a, b, cf):
    """(result, flag left) of a carry primitive by its definition: the
    flag of an add is the carry of a + b (+ cf), of a sub that of a + ~b
    + 1 (+ cf - 1 for subc_cc, subc); addc and subc leave it."""
    if op.startswith("add"):
        s = a + b + (cf if op != "add_cc" else 0)
    else:
        s = a + (b ^ 0xFFFFFFFF) + (cf if op != "sub_cc" else 1)
    keep = op in ("addc", "subc")
    return s & 0xFFFFFFFF, cf if keep else s >> 32


@pytest.mark.parametrize("op", CARRY_OPS)
def test_carry_primitive_on_the_flags_edges(lib, op):
    """Each carry primitive's host twin against its definition, with the
    flag coming in 0 and 1, on operand pairs whose sum (a + b, or a + ~b
    for a sub) is 2^32 - 2, 2^32 - 1, 2^32 and 2^32 + 1, and on random
    pairs: the result and the flag it leaves."""
    rs = np.random.RandomState(0xCC)
    firsts = [0, 1, 2, 977, 1 << 31, cc.M32 - 1, cc.M32]
    firsts += [int(v) for v in rs.randint(0, 1 << 32, 40, dtype=np.int64)]
    a, b = [], []
    for s in ((1 << 32) - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1):
        for x in firsts:
            y = s - x  # the second operand (add) or its complement (sub)
            if 0 <= y <= cc.M32:
                a.append(x)
                b.append(y if op.startswith("add") else y ^ cc.M32)
    a += [int(v) for v in rs.randint(0, 1 << 32, 500, dtype=np.int64)]
    b += [int(v) for v in rs.randint(0, 1 << 32, 500, dtype=np.int64)]
    a, b = a * 2, b * 2
    cin = [0] * (len(a) // 2) + [1] * (len(a) // 2)
    wa, wb = np.array(a, np.uint32), np.array(b, np.uint32)
    r = np.zeros_like(wa)
    cf = np.array(cin, np.uint32)
    assert lib.kt_carry_op_n(CARRY_OPS.index(op), r.ctypes.data,
                             cf.ctypes.data, wa.ctypes.data, wb.ctypes.data,
                             len(a)) == 0
    want = [carry_op(op, x, y, c) for x, y, c in zip(a, b, cin)]
    assert list(zip(r.tolist(), cf.tolist())) == want
    # both flags come out of the edges
    assert {w[1] for w in want} == {0, 1}


@pytest.mark.parametrize("case", cc.MUL_CASES)
@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_mul_sqr_every_carry_pattern(lib, op, case):
    """fe_mul and fe_sqr against Python ints on tests/carry_cases.py's
    operands: every pair of operands whose words are 0 or 2^32 - 1, the
    band [p, 2^256) against those, p - 1, p, p + 1, 2^255, 2^256 - 1
    against all, and 2^16 pairs of mixed words (squaring: each operand
    once).  Every result is below 2^256 and congruent to the product
    mod p."""
    if op == "mul":
        a, b = cc.mul_pairs(case)
        wa, wb = cc.to_words(a), cc.to_words(b)
        r = np.zeros_like(wa)
        lib.kt_fe_mul_n(r.ctypes.data, wa.ctypes.data, wb.ctypes.data,
                        len(a))
        want = [x * y for x, y in zip(a, b)]
    else:
        a = cc.sqr_values(case)
        wa = cc.to_words(a)
        r = np.zeros_like(wa)
        lib.kt_fe_sqr_n(r.ctypes.data, wa.ctypes.data, len(a))
        want = [x * x for x in a]
    assert cc.wrong(cc.to_ints(r), want) == 0


@pytest.mark.parametrize("case", cc.REDUCE_CASES)
def test_reduce512_every_carry_pattern(lib, case):
    """fe_reduce512 against Python ints on every 512-bit input whose 16
    words are 0 or 2^32 - 1, and on 2^16 inputs whose words are 0, 1,
    2^31, 2^32 - 2 or 2^32 - 1: below 2^256, congruent mod p; the card
    entry's plain version on the first 2048."""
    t = cc.reduce_inputs(case)
    wt = cc.to_words(t, 16)
    r = np.zeros((len(t), 8), np.uint32)
    lib.kt_fe_reduce512_n(r.ctypes.data, wt.ctypes.data, len(t))
    assert cc.wrong(cc.to_ints(r), t) == 0
    # the card entry's plain version, which it takes on the CPU
    few = wt[:2048]
    lo, hi = (torch.from_numpy(cc.to_limbs(np.ascontiguousarray(h.T)))
              for h in (few[:, :8], few[:, 8:]))
    plain = cc.from_limbs(probe_cuda.reduce512(lo, hi).numpy())
    assert cc.wrong(cc.to_ints(plain), t[:2048]) == 0


def test_sqr_inv_canon(lib):
    a, _ = operands()
    wa = words(a)
    r = np.zeros_like(wa)
    lib.kt_fe_sqr_n(r.ctypes.data, wa.ctypes.data, len(a))
    assert all((g - x * x) % P == 0 for g, x in zip(unwords(r), a))
    lib.kt_fe_inv_n(r.ctypes.data, wa.ctypes.data, len(a))
    assert unwords(r) == [pow(x, P - 2, P) for x in a]   # inv(0) == 0
    vals = [v for v in a if v < 2 * P]
    c = words(vals)
    lib.kt_fe_canon_n(c.ctypes.data, len(vals))
    assert unwords(c) == [v % P for v in vals]


def test_fe_inv_safegcd_matches_fermat_and_jax_modinv(lib):
    """fe_inv (safegcd) against pow(x, p-2, p) and the JAX package's
    modinv on the same inputs: edge cases 0 (inv(0) = 0), 1, p - 1,
    relaxed inputs p .. 2^256 - 1 (fe_inv canonicalizes first; modinv
    takes their canonical value) and random values; canonical results,
    bit-equal."""
    edge = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (P + 1) // 2, P, P + 1,
            P + 2, (1 << 256) - 1, (1 << 256) - 2, (1 << 32) + 977,
            1 << 255, (1 << 255) - 1, 1 << 224]
    rnd = [int.from_bytes(RS.bytes(32), "little") for _ in range(496)]
    vals = edge + [v % P if i % 2 else v for i, v in enumerate(rnd)]
    wa = words(vals)
    r = np.zeros_like(wa)
    lib.kt_fe_inv_n(r.ctypes.data, wa.ctypes.data, len(vals))
    got = unwords(r)
    assert got == [pow(v % P, P - 2, P) for v in vals]
    canon = words([v % P for v in vals])
    limbs = np.empty((16, len(vals)), np.uint32)
    limbs[0::2], limbs[1::2] = (canon & 0xFFFF).T, (canon >> 16).T
    jax_inv = np.asarray(jax.jit(jfield.modinv)(jnp.asarray(limbs)))
    assert got == unwords(np.ascontiguousarray(
        (jax_inv[0::2] | (jax_inv[1::2] << 16)).T))


def test_add_u128(lib):
    d = [int.from_bytes(RS.bytes(16), "little") for _ in range(500)]
    e = [int.from_bytes(RS.bytes(16), "little") for _ in range(500)]
    d[:2], e[:2] = [(1 << 128) - 1, 1 << 127], [1, 1 << 127]
    wd, we = words(d, 4), words(e, 4)
    lib.kt_add_u128_n(wd.ctypes.data, we.ctypes.data, len(d))
    assert unwords(wd) == [(x + y) % (1 << 128) for x, y in zip(d, e)]


def test_symmetry_helpers(lib):
    """fe_is_high (y > (p-1)/2), fe_neg (p - y) and neg_u128 (128-bit
    two's complement) against ints, with the class boundary's edges."""
    half = (P - 1) // 2
    ys = [0, 1, half - 1, half, half + 1, half + 2, P - 2, P - 1]
    ys += [int.from_bytes(RS.bytes(32), "little") % P for _ in range(500)]
    wy = words(ys)
    hi = np.zeros(len(ys), np.uint32)
    lib.kt_fe_is_high_n(hi.ctypes.data, wy.ctypes.data, len(ys))
    assert hi.tolist() == [int(y > half) for y in ys]
    r = np.zeros_like(wy)
    lib.kt_fe_neg_n(r.ctypes.data, wy.ctypes.data, len(ys))
    assert unwords(r) == [(P - y) % (1 << 256) for y in ys]
    ds = [0, 1, 1 << 127, (1 << 127) - 1, (1 << 128) - 1]
    ds += [int.from_bytes(RS.bytes(16), "little") for _ in range(500)]
    wd = words(ds, 4)
    lib.kt_neg_u128_n(wd.ctypes.data, len(ds))
    assert unwords(wd) == [(-v) % (1 << 128) for v in ds]


NAMES = ("px", "py", "d", "count", "dpx", "dpd", "step")
KEYS = ("px", "py", "d", "jx", "jy", "jd", "masks")


def _host_window(lib, st, nb_run, slots, symclass=None):
    """One launch window of the kernel body on the host (plain mode, or
    symmetry mode with a symclass); returns its outputs as tensors."""
    n = st["px"].shape[1]
    t = interop.from_numpy_state(st, "cpu")
    hx, hy, hd, jx, jy, jd, masks = (t[k] for k in KEYS)
    count = torch.zeros(n, dtype=torch.int32)
    dpx = torch.zeros((slots, 10, n), dtype=torch.int32)
    dpd = torch.zeros((slots, 8, n), dtype=torch.int32)
    step = torch.zeros((slots, n), dtype=torch.int32)
    scratch = torch.full((jump_cuda.SCRATCH_ROWS, n), -1, dtype=torch.int32)
    sc = None if symclass is None else torch.from_numpy(
        symclass.astype(np.int32))
    rc = lib.kt_walk_host(
        *(x.data_ptr() for x in (hx, hy, hd, jx, jy, jd, masks)),
        n, nb_run, slots,
        *(x.data_ptr() for x in (count, dpx, dpd, step)),
        None if sc is None else sc.data_ptr(), scratch.data_ptr())
    assert rc == 0
    out = (hx, hy, hd, count, dpx, dpd, step)
    return out if sc is None else out + (sc,)


# (dp_size, slots) of a window with and without slot overflow
WINDOWS = pytest.mark.parametrize("dp_size,slots", [(4, 2), (12, 3)],
                                  ids=["overflow", "sparse"])


@WINDOWS
def test_kernel_body_matches_plain_walk(lib, dp_size, slots):
    """One launch window of the kernel body at its real geometry (one
    block of THREADS x GROUP lanes) vs the JAX reference walk and the
    port's plain walk, on the JAX package's herd and tables."""
    n, nb_run, rp = jump_cuda.LANE_QUANTUM, 6, 64
    assert lib.kt_lane_quantum() == n
    wd2 = ((1 << rp) - 1) >> 1
    px, py, d = jherd.create_herd(n, rp, wd2, jcurve.mul(0xDEADBEEF12345),
                                  0, MT19937(7))
    jx, jy, jd = create_jump_table(rp).as_arrays()
    st = dict(px=px, py=py, d=d, jx=jx, jy=jy, jd=jd,
              masks=jref.dp_limb_masks(dp_size))
    jax_out = jref.jump_steps_with_dp(
        *(jnp.asarray(st[k]) for k in KEYS),
        nb_run=nb_run, inv_stop=64, slots=slots)
    t = interop.from_numpy_state(st, "cpu")
    plain = jump_ref.jump_steps_with_dp(*[t[k] for k in KEYS],
                                        nb_run=nb_run, slots=slots)
    got = _host_window(lib, st, nb_run, slots)
    count = got[3]
    want_jax = interop.from_numpy_state(
        {k: np.asarray(v) for k, v in zip(NAMES, jax_out)}, "cpu")
    for name, g, w, w2 in zip(NAMES, got, plain,
                              (want_jax[k] for k in NAMES)):
        if name == "py":
            g, w, w2 = (field.canonicalize(x) for x in (g, w, w2))
        assert torch.equal(g, w2), f"{name} vs JAX jump_ref"
        assert torch.equal(g, w), f"{name} vs the plain walk"
    assert int(count.sum()) > 0
    assert bool((count > slots).any()) == (dp_size == 4)


@WINDOWS
def test_sym_kernel_body_matches_plain_walk(lib, dp_size, slots):
    """The symmetry kernel body at its real geometry, from a symclass
    input that holds both classes, vs the JAX reference walk in
    symmetry mode and the port's plain symmetry walk: px, py (both
    canonical), d, count, every slot and symclass bit-equal.  Both
    passes of the kernel index the table by the lane's class, and only
    the backward pass writes the new one: a kernel that let the forward
    pass see the new class would disagree here."""
    n, nb_run, rp = jump_cuda.LANE_QUANTUM, 6, 64
    wd2 = ((1 << rp) - 1) >> 1
    px, py, d = jherd.create_herd(n, rp, wd2, jcurve.mul(0xDEADBEEF12345),
                                  1, MT19937(8), symmetry=True)
    jx, jy, jd = create_jump_table(rp, symmetry=True).as_arrays()
    st = dict(px=px, py=py, d=d, jx=jx, jy=jy, jd=jd,
              masks=jref.dp_limb_masks(dp_size))
    sc = np.random.RandomState(0x5C).randint(0, 2, n).astype(np.uint32)
    jax_out = jref.jump_steps_with_dp(
        *(jnp.asarray(st[k]) for k in KEYS), nb_run=nb_run, inv_stop=64,
        slots=slots, symmetry=True, symclass=jnp.asarray(sc))
    t = interop.from_numpy_state(dict(st, sc=sc), "cpu")
    plain = jump_ref.jump_steps_with_dp(
        *[t[k] for k in KEYS], nb_run=nb_run, slots=slots, symmetry=True,
        symclass=t["sc"])
    got = _host_window(lib, st, nb_run, slots, symclass=sc)
    names = NAMES + ("symclass",)
    want_jax = interop.from_numpy_state(
        {k: np.asarray(v) for k, v in zip(names, jax_out)}, "cpu")
    for name, g, w in zip(names, got, plain):
        assert torch.equal(g, want_jax[name]), f"{name} vs JAX jump_ref"
        assert torch.equal(g, w), f"{name} vs the plain walk"
    count, new_sc = got[3], got[7]
    assert int(count.sum()) > 0
    assert bool((count > slots).any()) == (dp_size == 4)
    # the window flipped some lanes' classes and kept others
    flipped = int((new_sc != torch.from_numpy(sc.astype(np.int32))).sum())
    assert 0 < flipped < n
