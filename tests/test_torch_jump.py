"""kangaroo_torch walk vs the JAX package's walk, in lockstep.

The plain PyTorch walk (ops/jump_ref.py, the plain version of the CUDA
kernel) runs a full launch window on the herd and tables of the JAX
package, carried across with interop.from_numpy_state; the JAX
reference walk (under jit on the CPU) and the Pallas kernel (interpret
mode, as tests/test_lockstep.py runs it) run the same window.  The
contract of core/check.py:330-333: px, d, count and every DP slot
bit-equal, py equal mod p.  One case overflows the capture slots.  The
symmetry walk also returns symclass, and its py is canonical: there
every output is compared bit for bit, against the JAX reference walk and
against the Pallas kernel in both its eager (n <= WALKW) and its
deferred-flip (n > WALKW) branch.
"""

from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from kangaroo_tpu.constants import P  # noqa: E402
from kangaroo_tpu.core import curve as jcurve, herd as jherd  # noqa: E402
from kangaroo_tpu.core.jumptable import create_jump_table  # noqa: E402
from kangaroo_tpu.ops import jump_pallas, jump_ref as jref  # noqa: E402
from kangaroo_tpu.utils.intutils import limbs_to_ints_fast  # noqa: E402
from kangaroo_tpu.utils.rng import MT19937  # noqa: E402
from kangaroo_torch import interop  # noqa: E402
from kangaroo_torch.ops import jump_cuda, jump_ref  # noqa: E402

NAMES = ("px", "py", "d", "count", "dpx", "dpd", "step")
RANGE_POWER = 64


@lru_cache(maxsize=None)
def _herd_and_tables(n, seed=99, symmetry=False, range_power=RANGE_POWER):
    wd2 = ((1 << range_power) - 1) >> 1
    px, py, d = jherd.create_herd(n, range_power, wd2,
                                  jcurve.mul(0xDEADBEEF12345), 0,
                                  MT19937(seed), symmetry=symmetry)
    jx, jy, jd = create_jump_table(range_power, symmetry).as_arrays()
    return dict(px=px, py=py, d=d, jx=jx, jy=jy, jd=jd)


def _inputs(n, dp_size, **herd):
    return dict(_herd_and_tables(n, **herd),
                masks=jref.dp_limb_masks(dp_size))


def _torch_walk(st, nb_run, slots, symclass=None):
    s = interop.from_numpy_state(st, "cpu")
    sym = symclass is not None
    out = jump_ref.jump_steps_with_dp(
        s["px"], s["py"], s["d"], s["jx"], s["jy"], s["jd"], s["masks"],
        nb_run=nb_run, slots=slots, symmetry=sym,
        symclass=torch.from_numpy(symclass.astype(np.int32)) if sym else None)
    return interop.to_numpy_state(
        dict(zip(NAMES + (("symclass",) if sym else ()), out)))


def _sym_start(n, seed):
    """A symmetry herd and a seeded class input holding both classes."""
    st = _herd_and_tables(n, seed=seed, symmetry=True, range_power=48)
    sc = np.random.RandomState(seed).randint(0, 2, n).astype(np.uint32)
    return st, sc


def _assert_sym_equal(got, want):
    for name in NAMES + ("symclass",):
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)


def _assert_contract(got, want):
    for name in NAMES:
        a, b = got[name], np.asarray(want[name])
        assert a.shape == b.shape, name
        if name == "py":
            x, y = limbs_to_ints_fast(a), limbs_to_ints_fast(b)
            assert all((int(u) - int(v)) % P == 0 for u, v in zip(x, y))
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dp_size,slots", [(6, 2), (3, 2)],
                         ids=["dp6", "overflow"])
def test_plain_walk_matches_jax_ref(dp_size, slots):
    n, nb_run = 256, 16
    st = _inputs(n, dp_size)
    got = _torch_walk(st, nb_run, slots)
    want = jref.jump_steps_with_dp(
        *(jnp.asarray(st[k]) for k in ("px", "py", "d", "jx", "jy", "jd",
                                       "masks")),
        nb_run=nb_run, inv_stop=64, slots=slots)
    _assert_contract(got, dict(zip(NAMES, want)))
    assert got["count"].sum() > 0
    # the overflow case really overflows (hits beyond the slots are
    # counted, not stored), the dp6 case stays within them
    assert (got["count"] > slots).any() == (dp_size == 3)


def test_plain_walk_matches_pallas_interpret():
    n, nb_run, dp_size = 256, 16, 6
    st = _inputs(n, dp_size)
    got = _torch_walk(st, nb_run, 2)
    want = jump_pallas.jump_steps_with_dp(
        *(jnp.asarray(st[k]) for k in ("px", "py", "d", "jx", "jy", "jd",
                                       "masks")),
        nb_run=nb_run, block=n, interpret=True)
    _assert_contract(got, dict(zip(NAMES, want)))


@pytest.mark.parametrize("dp_size,slots", [(5, 4), (5, 1)],
                         ids=["dp5", "overflow"])
def test_sym_walk_matches_jax_ref(dp_size, slots):
    n, nb_run = 256, 12
    st, sc = _sym_start(n, 77)
    st = dict(st, masks=jref.dp_limb_masks(dp_size))
    got = _torch_walk(st, nb_run, slots, symclass=sc)
    want = jref.jump_steps_with_dp(
        *(jnp.asarray(st[k]) for k in ("px", "py", "d", "jx", "jy", "jd",
                                       "masks")),
        nb_run=nb_run, inv_stop=64, slots=slots, symmetry=True,
        symclass=jnp.asarray(sc))
    _assert_sym_equal(got, dict(zip(NAMES + ("symclass",), want)))
    assert got["count"].sum() > 0
    assert (got["count"] > slots).any() == (slots == 1)
    assert 0 < (got["symclass"] != sc).sum() < n


@pytest.mark.parametrize("n,nb_run", [(128, 12), (1024, 4)],
                         ids=["eager", "deferred"])
def test_sym_walk_matches_pallas_interpret(n, nb_run):
    """The Pallas kernel normalizes eagerly at n <= WALKW and defers
    the flips to its epilogue above (test_lockstep.py runs both)."""
    assert (n > jump_pallas.WALKW) == (n == 1024)
    st, sc = _sym_start(n, 31337)
    st = dict(st, masks=jref.dp_limb_masks(4))
    got = _torch_walk(st, nb_run, 2, symclass=sc)
    want = jump_pallas.jump_steps_with_dp(
        *(jnp.asarray(st[k]) for k in ("px", "py", "d", "jx", "jy", "jd",
                                       "masks")),
        nb_run=nb_run, block=n, interpret=True, symmetry=True,
        symclass=jnp.asarray(sc))
    _assert_sym_equal(got, dict(zip(NAMES + ("symclass",), want)))
    assert got["count"].sum() > 0


def test_cpu_tensor_takes_the_plain_walk():
    st = interop.from_numpy_state(_inputs(256, 4), "cpu")
    calls = jump_ref.CALLS
    launches = (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES)
    out = jump_cuda.jump_steps_with_dp(
        st["px"], st["py"], st["d"], st["jx"], st["jy"], st["jd"],
        st["masks"], nb_run=2, slots=3)
    assert jump_ref.CALLS == calls + 1
    assert (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES) == launches
    n = 256
    assert [tuple(o.shape) for o in out] == [
        (16, n), (16, n), (8, n), (n,), (3, 10, n), (3, 8, n), (3, n)]
    assert all(o.dtype == torch.int32 for o in out)
    # symmetry mode too; no class given means every lane in class 0
    sym = jump_cuda.jump_steps_with_dp(
        st["px"], st["py"], st["d"], st["jx"], st["jy"], st["jd"],
        st["masks"], nb_run=2, slots=3, symmetry=True)
    assert jump_ref.CALLS == calls + 2
    assert (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES) == launches
    assert len(sym) == 8 and tuple(sym[7].shape) == (n,)
    assert sym[7].dtype == torch.int32 and int(sym[7].max()) <= 1


def test_dp_masks_and_interop_round_trip():
    for dp in (0, 1, 6, 16, 17, 63, 64, 70):
        np.testing.assert_array_equal(
            jump_ref.dp_limb_masks(dp).numpy().astype(np.uint32),
            jref.dp_limb_masks(dp))
    st = _inputs(256, 6)
    back = interop.to_numpy_state(interop.from_numpy_state(st, "cpu"))
    for k, v in st.items():
        assert back[k].dtype == np.uint32
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError):
        interop.from_numpy_state({"bad": np.array([1 << 31], np.uint64)},
                                 "cpu")
