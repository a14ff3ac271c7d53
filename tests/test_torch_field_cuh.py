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
    field, host_kernel, jump_cuda, jump_ref)

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
