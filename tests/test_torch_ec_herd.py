"""kangaroo_torch curve ops and herd creation vs the JAX package.

The batched scalar multiply is held against the JAX package's and the
exact host curve.mul (as tests/test_ec.py does); for the same MT19937
seed the port's herd must equal the JAX herd lane for lane (as
tests/test_herd.py checks the JAX herd against its per-lane oracle), in
plain and in symmetry mode, and its jump tables the JAX tables.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from kangaroo_tpu.constants import N_ORDER, TAME  # noqa: E402
from kangaroo_tpu.core import curve as jcurve, herd as jherd  # noqa: E402
from kangaroo_tpu.core import jumptable as jjumptable  # noqa: E402
from kangaroo_tpu.ops import ec as jec  # noqa: E402
from kangaroo_tpu.utils.intutils import (  # noqa: E402
    ints_to_limbs_fast,
    limbs_to_ints_fast,
)
from kangaroo_tpu.utils.rng import MT19937 as JMT  # noqa: E402
from kangaroo_torch import interop  # noqa: E402
from kangaroo_torch.core import curve, herd, jumptable  # noqa: E402
from kangaroo_torch.ops import ec  # noqa: E402
from kangaroo_torch.utils.rng import MT19937  # noqa: E402

rng = random.Random(0xEC0D)


def test_scalar_mult_base_batch_vs_jax_and_curve():
    ks = [rng.randrange(N_ORDER) for _ in range(61)] + [0]
    ks[:8] = [1, 2, 3, 255, 256, 257, 65537, N_ORDER - 1]
    limbs = ints_to_limbs_fast(ks)
    x, y, z = ec.scalar_mult_base_batch(
        torch.from_numpy(limbs.astype(np.int32)))
    jx, jy, jz = jec.scalar_mult_base_batch(jnp.asarray(limbs))
    got = interop.to_numpy_state(dict(x=x, y=y))
    np.testing.assert_array_equal(got["x"], np.asarray(jx))
    np.testing.assert_array_equal(got["y"], np.asarray(jy))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    xs, ys = limbs_to_ints_fast(got["x"]), limbs_to_ints_fast(got["y"])
    for k, gx, gy, gz in zip(ks, xs, ys, z.tolist()):
        want = jcurve.mul(k)
        assert gz == (k == 0)
        if k:
            assert (int(gx), int(gy)) == (want.x, want.y), hex(k)


def test_affine_add_masked_vs_curve():
    n = 24
    p1 = [jcurve.mul(rng.randrange(1, N_ORDER)) for _ in range(n)]
    p2 = [jcurve.mul(rng.randrange(1, N_ORDER)) for _ in range(n)]
    z1 = torch.tensor([i % 5 == 0 for i in range(n)])
    z2 = torch.tensor([i % 7 == 0 for i in range(n)])

    def t(vals):
        return torch.from_numpy(ints_to_limbs_fast(vals).astype(np.int32))

    ox, oy, oz = ec.affine_add_batch_masked(
        t([p.x for p in p1]), t([p.y for p in p1]), z1,
        t([p.x for p in p2]), t([p.y for p in p2]), z2)
    for i in range(n):
        a = jcurve.ZERO if z1[i] else p1[i]
        b = jcurve.ZERO if z2[i] else p2[i]
        want = jcurve.add(a, b)
        assert bool(oz[i]) == want.is_zero
        if not want.is_zero:
            got = (int(limbs_to_ints_fast(ox[:, i:i + 1].numpy())[0]),
                   int(limbs_to_ints_fast(oy[:, i:i + 1].numpy())[0]))
            assert got == (want.x, want.y), i


@pytest.mark.parametrize("first_type", [TAME, 1])
def test_create_herd_equals_jax_herd(first_type):
    nb, range_power = 64, 40
    width_div2 = 1 << 39
    kp = 0xDEADBEEF7
    jpx, jpy, jd = jherd.create_herd(nb, range_power, width_div2,
                                     jcurve.mul(kp), first_type, JMT(1234))
    px, py, d = herd.create_herd(nb, range_power, width_div2, curve.mul(kp),
                                 first_type, MT19937(1234), device="cpu")
    got = interop.to_numpy_state(dict(px=px, py=py, d=d))
    np.testing.assert_array_equal(got["px"], np.asarray(jpx))
    np.testing.assert_array_equal(got["py"], np.asarray(jpy))
    np.testing.assert_array_equal(got["d"], np.asarray(jd))


@pytest.mark.parametrize("first_type", [TAME, 1])
def test_create_sym_herd_equals_jax_herd(first_type):
    """Symmetry herd: draws of range_power - 1 bits, wild offset W/4,
    signed distances, and start points normalized into their class
    (lanes with y > (p-1)/2 take p - y and the negated distance)."""
    nb, range_power = 96, 40
    width_div2 = (1 << 39) - 5
    kp = 0xDEADBEEF7
    jpx, jpy, jd = jherd.create_herd(nb, range_power, width_div2,
                                     jcurve.mul(kp), first_type, JMT(4321),
                                     symmetry=True)
    px, py, d = herd.create_herd(nb, range_power, width_div2, curve.mul(kp),
                                 first_type, MT19937(4321), device="cpu",
                                 symmetry=True)
    got = interop.to_numpy_state(dict(px=px, py=py, d=d))
    np.testing.assert_array_equal(got["px"], np.asarray(jpx))
    np.testing.assert_array_equal(got["py"], np.asarray(jpy))
    np.testing.assert_array_equal(got["d"], np.asarray(jd))
    # some lanes were flipped (their distance sign differs from the
    # draw's) and some carry negative distances
    r = herd.draw_start_words(nb, range_power, MT19937(4321), symmetry=True)
    rv = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in r]
    wild = (np.arange(nb) + first_type) % 2 == 1
    drawn = [v - (width_div2 >> 1) if w else v for v, w in zip(rv, wild)]
    dv = [int(v) for v in limbs_to_ints_fast(got["d"])]
    signed = [v - (1 << 128) if v >> 127 else v for v in dv]
    flipped = [s == -t != 0 for s, t in zip(signed, drawn)]
    assert all(s in (t, -t) for s, t in zip(signed, drawn))
    assert 0 < sum(flipped) < nb
    assert any(s < 0 for s in signed)


@pytest.mark.parametrize("range_power,symmetry",
                         [(32, False), (40, True), (64, True), (76, True)])
def test_jump_tables_equal_jax(range_power, symmetry):
    want = jjumptable.create_jump_table(range_power, symmetry=symmetry)
    got = jumptable.create_jump_table(range_power, symmetry=symmetry)
    assert got.distances == want.distances
    assert (got.jump_bit, got.avg) == (want.jump_bit, want.avg)
    for a, b in zip(got.as_arrays(), want.as_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("range_power", [40, 64, 96, 125])
def test_draws_match_jax_distances(range_power):
    """Raw draws r: tame lanes start at r, wild lanes at r - W/2 (mod n)
    as in the JAX draw_start_distances, and both carry r on the device
    (the JAX pack_device_distances)."""
    nb = 48
    wd2 = (1 << (range_power - 1)) - 3
    r = herd.draw_start_words(nb, range_power, MT19937(5))
    rv = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in r]
    d_modn = jherd.draw_start_distances(nb, range_power, wd2, TAME, JMT(5))
    types = np.arange(nb, dtype=np.uint32) % 2
    assert d_modn == [(v - wd2) % N_ORDER if t else v
                      for v, t in zip(rv, types)]
    np.testing.assert_array_equal(
        jherd.pack_device_distances(d_modn, types, wd2),
        ints_to_limbs_fast(rv, 8))
    with pytest.raises(ValueError):
        herd.draw_start_words(1, 129)


def test_limb_packing_matches_jax():
    from kangaroo_tpu.utils.intutils import ints_to_limbs_fast as jpack
    from kangaroo_torch.utils.intutils import ints_to_limbs_fast as tpack

    rs = np.random.RandomState(3)
    vals = [int.from_bytes(rs.bytes(32), "little") >> 1 for _ in range(64)]
    vals += [0, 1, (1 << 256) - 1]
    np.testing.assert_array_equal(tpack(vals), jpack(vals))
    negs = [-1, -(1 << 64), -123456789, (1 << 128) - 1]
    np.testing.assert_array_equal(tpack(negs, 8), jpack(negs, 8))
    for bad in ([1 << 256], [-(1 << 256) - 1]):
        with pytest.raises(OverflowError):
            tpack(bad)
