"""kangaroo_torch field arithmetic vs the JAX package and Python ints.

Every op of kangaroo_torch.ops.field runs on the same inputs as its
kangaroo_tpu.ops.field counterpart: the structured operand pool of
core/check.py (powers of two, p - k, small k, long zero runs,
alternating bits) plus seeded random values.  Canonical outputs are
compared bit for bit, relaxed outputs (any representative < 2^256) mod
p.  Tolerance 0 everywhere: this is integer arithmetic.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kangaroo_tpu.constants import P  # noqa: E402
from kangaroo_tpu.core.check import structured_field_values  # noqa: E402
from kangaroo_tpu.ops import field as jfield  # noqa: E402
from kangaroo_tpu.utils.intutils import (  # noqa: E402
    ints_to_limbs_fast,
    limbs_to_ints_fast,
)
from kangaroo_torch.ops import field  # noqa: E402

RS = np.random.RandomState(0x7F1E1D)
POOL = structured_field_values()
N_JAX = 512  # lanes also pushed through the JAX package


def _rand(n, bits=256):
    return [int.from_bytes(RS.bytes(32), "little") >> (256 - bits)
            for _ in range(n)]


# (a, b) operand pairs: structured pool against random, plus relaxed
# (>= p) random operands and the top of the 2^256 range
A = POOL + _rand(512) + [(1 << 256) - 1, P, P + 1, 0]
B = _rand(len(POOL)) + _rand(512) + [(1 << 256) - 1, (1 << 256) - 1, P, 1]


def t(vals, rows=16):
    return torch.from_numpy(ints_to_limbs_fast(vals, rows).astype(np.int32))


def ints(a):
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.int32
        a = a.numpy()
    return [int(v) for v in limbs_to_ints_fast(np.asarray(a).astype(np.uint32))]


def j(vals, rows=16):
    return jnp.asarray(ints_to_limbs_fast(vals, rows))


def assert_relaxed(got, want):
    assert all(g < (1 << 256) for g in got)
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if (g - w) % P]
    assert not bad, f"lanes differ mod p: {bad[:8]}"


BINARY = [
    ("addmod", lambda x, y: x + y),
    ("submod", lambda x, y: x - y),
    ("mulmod", lambda x, y: x * y),
]


@pytest.mark.parametrize("name,op", BINARY, ids=[b[0] for b in BINARY])
def test_binary_ops_vs_ints_and_jax(name, op):
    got = ints(getattr(field, name)(t(A), t(B)))
    assert_relaxed(got, [op(a, b) for a, b in zip(A, B)])
    jgot = ints(jax.jit(getattr(jfield, name))(j(A[:N_JAX]), j(B[:N_JAX])))
    assert_relaxed(got[:N_JAX], jgot)


@pytest.mark.parametrize("fn", ["mulmod", "sqrmod"])
def test_fused_subtrahends(fn):
    c, d = _rand(len(A)), B[::-1]
    if fn == "mulmod":
        got = field.mulmod(t(A), t(B), sub=(t(c), t(d)))
        want = [a * b - x - y for a, b, x, y in zip(A, B, c, d)]
        jgot = jax.jit(lambda a, b, x, y: jfield.mulmod(a, b, sub=(x, y)))(
            *(j(v[:N_JAX]) for v in (A, B, c, d)))
    else:
        got = field.sqrmod(t(A), sub=(t(c),))
        want = [a * a - x for a, x in zip(A, c)]
        jgot = jax.jit(lambda a, x: jfield.sqrmod(a, sub=(x,)))(
            j(A[:N_JAX]), j(c[:N_JAX]))
    got = ints(got)
    assert_relaxed(got, want)
    assert_relaxed(got[:N_JAX], ints(jgot))


def test_canonicalize_bit_exact():
    vals = [v for v in A] + [P + k for k in range(64)] + [(1 << 256) - 1]
    got = ints(field.canonicalize(t(vals)))
    assert got == [v % P for v in vals]
    assert got[:N_JAX] == ints(jax.jit(jfield.canonicalize)(j(vals[:N_JAX])))


def test_modinv_canonical_equals_jax():
    vals = POOL[:N_JAX - 1] + [0]
    got = ints(field.modinv(t(vals)))
    assert got == [pow(v, P - 2, P) for v in vals]        # inv(0) == 0
    assert got == ints(jax.jit(jfield.modinv)(j(vals)))


@pytest.mark.parametrize("n", [1024, 96, 1])
def test_batch_inv(n):
    """Power-of-two, odd-root (96 = 3 * 2^5) and single-lane widths."""
    vals = [v % P or 1 for v in (POOL[::3] + _rand(n))[:n]]
    got = field.batch_inv(t(vals))
    assert_relaxed(ints(got), [pow(v, P - 2, P) for v in vals])
    assert ints(field.canonicalize(got)) == [pow(v, P - 2, P) for v in vals]


def test_add_u128_and_predicates():
    d, e = _rand(600, 128), _rand(600, 128)
    d[:3] = [(1 << 128) - 1, 0, 1 << 127]
    e[:3] = [1, 0, 1 << 127]
    got = ints(field.add_u128(t(d, 8), t(e, 8)))
    assert got == [(x + y) % (1 << 128) for x, y in zip(d, e)]
    assert got == ints(jax.jit(jfield.add_u128)(j(d, 8), j(e, 8)))
    a, b = t(A[:300]), t(A[:300])
    b[5, 7] += 1
    assert field.eq(a, b).tolist() == [i != 7 for i in range(300)]
    z = t([0, 1, P, 0])
    assert field.is_zero(z).tolist() == [True, False, False, True]


def test_symmetry_helpers_vs_ints_and_jax():
    """neg_u128, y_is_high and neg_y (the symmetry walk's class
    normalization) against Python ints and the JAX package, with the
    edges of the class boundary and of the signed distance."""
    half = (P - 1) // 2
    ys = [0, 1, half - 1, half, half + 1, half + 2, P - 2, P - 1]
    ys += [v % P for v in POOL] + [v % P for v in _rand(400)]
    high = field.y_is_high(t(ys))
    assert high.dtype == torch.int32
    assert high.tolist() == [int(y > half) for y in ys]
    negy = ints(field.neg_y(t(ys)))
    assert negy == [(P - y) % (1 << 256) for y in ys]
    assert negy[1:] == [P - y for y in ys[1:]]        # canonical for y > 0
    ds = [0, 1, 1 << 127, (1 << 127) - 1, (1 << 128) - 1] + _rand(300, 128)
    negd = ints(field.neg_u128(t(ds, 8)))
    assert negd == [(-v) % (1 << 128) for v in ds]
    n = N_JAX
    jy, jd = j(ys[:n]), j(ds[:n], 8)
    assert high.tolist()[:n] == np.asarray(
        jax.jit(jfield.y_is_high)(jy)).tolist()
    assert negy[:n] == ints(jax.jit(jfield.neg_y)(jy))
    assert negd[:n] == ints(jax.jit(jfield.neg_u128)(jd))


def test_outputs_are_int32_limbs():
    for r in (field.addmod(t(A), t(B)), field.submod(t(A), t(B)),
              field.mulmod(t(A), t(B)), field.canonicalize(t(A))):
        assert r.dtype == torch.int32 and r.shape == (16, len(A))
        assert int(r.min()) >= 0 and int(r.max()) <= 0xFFFF
