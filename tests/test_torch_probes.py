"""The probe kernels' plain versions and g++-built bodies, on the CPU.

Each plain version (kangaroo_torch/ops/probe_ref.py) is held against the
TPU probe's own kernel body, loaded from scripts/ and run through
pl.pallas_call(..., interpret=True), or -- where the body applies a
non-field operation (xor, | 1) to a relaxed value, so that its chain
depends on which representative the field ops return -- against the
probe's op sequence in kangaroo_tpu.ops.field with canonicalize
inserted where the port's kernels call fe_canon.  The g++ build of the
kernels' own bodies (csrc/probes.cuh, walk.cuh through host_shim.cpp)
is held against the plain versions on the same inputs.  Field values
are compared canonical, integers bit for bit, f32 with rtol 1e-5.
No card is needed: tests/test_torch_cuda.py runs the kernels.
"""

import functools
import importlib.util
import shutil
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from kangaroo_tpu.ops import field as jfield  # noqa: E402
from kangaroo_tpu.ops import jump_pallas, jump_ref as jref  # noqa: E402
from kangaroo_torch.core.jumptable import create_jump_table  # noqa: E402
from kangaroo_torch.ops import (  # noqa: E402
    field, host_kernel, jump_cuda, jump_ref, probe_cuda, probe_ref)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
N = 128
ROUNDS = 4


def tpu_script(name):
    """A TPU probe script of scripts/, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_probe_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rand_limbs(rs, rows, n, low=0):
    return rs.randint(low, 1 << 16, (rows, n)).astype(np.uint32)


def t32(a):
    """uint32 numpy/JAX array -> int32 tensor (limbs, or the u32 bits)."""
    return torch.from_numpy(np.asarray(a).astype(np.uint32).view(np.int32))


def canon(t):
    return field.canonicalize(t)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: cannot build csrc/ for the host")
    return host_kernel.load()


# ---- P1: field chains vs scripts/pkbench.py ----

TPU_OPS = {
    "mul": lambda x, y: jfield.mulmod(x, y),
    "sqr": lambda x, y: jfield.sqrmod(x),
    "sub": lambda x, y: jfield.submod(x, y),
    "add": lambda x, y: jfield.addmod(x, y),
    "canon": lambda x, y: jfield.canonicalize(x),
    "gather": lambda x, y: x ^ jump_pallas._gather_onehot(
        x[0] & jnp.uint32(31), y),
}


@pytest.mark.parametrize("op", list(TPU_OPS))
def test_field_chain_matches_pkbench_body(op):
    """pkbench's chain_kernel (its TPU body, interpret mode) on (16, 128)
    for 4 rounds; the gather's b is the (16, 32) table, as in pkbench."""
    pk = tpu_script("pkbench")
    rs = np.random.RandomState(7)
    a = rand_limbs(rs, 16, N)
    b = rand_limbs(rs, 16, 32 if op == "gather" else N)
    f = pl.pallas_call(pk.chain_kernel(TPU_OPS[op], ROUNDS),
                       out_shape=jax.ShapeDtypeStruct(a.shape, jnp.uint32),
                       interpret=True)
    want = t32(f(jnp.asarray(a), jnp.asarray(b)))
    if op == "gather":
        got = probe_ref.field_chain(op, t32(a), None, ROUNDS, jx=t32(b))
        assert torch.equal(got, want)
    else:
        got = probe_ref.field_chain(op, t32(a), t32(b), ROUNDS)
        assert torch.equal(canon(got), canon(want))


def test_step_chain_matches_pkbench_sequence():
    """pkbench's step_op with canonicalize inserted before x3 ^ y3 (its
    body xors the relaxed y3): the jump-table gather, the affine add
    with batch_inv(stop=128), x <- x3 ^ canon(y3), y fixed."""
    rs = np.random.RandomState(11)
    a, b = rand_limbs(rs, 16, N), rand_limbs(rs, 16, N)
    jx, jy = rand_limbs(rs, 16, 32), rand_limbs(rs, 16, 32)

    @jax.jit
    def step(x, y):
        jmp = x[0] & jnp.uint32(31)
        qx, qy = jnp.take(jx, jmp, axis=1), jnp.take(jy, jmp, axis=1)
        x3, y3 = jref.affine_add_walk(x, y, qx, qy, inv_stop=N)
        return x3 ^ jfield.canonicalize(y3)

    x = jnp.asarray(a)
    for _ in range(2):
        x = step(x, jnp.asarray(b))
    got = probe_ref.field_chain("step", t32(a), t32(b), 2, t32(jx), t32(jy))
    assert torch.equal(got, t32(x))


# ---- P2: raw chains vs scripts/probe_ops.py and layout_probe.py ----

PROBE_OPS = {
    "u32_add": lambda a, b, i: (a + b) + i,
    "u32_mul": lambda a, b, i: (a * b) + i,
}


@pytest.mark.parametrize("op", list(PROBE_OPS))
def test_raw_chain_matches_probe_ops_body(op, monkeypatch):
    """probe_ops' kernel body on (256, 8) for 16 iterations, bit-equal."""
    po = tpu_script("probe_ops")
    monkeypatch.setattr(po, "ROWS", 256)
    monkeypatch.setattr(po, "COLS", 8)
    monkeypatch.setattr(po, "INNER", 16)
    monkeypatch.setattr(po, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    x = np.random.RandomState(0).randint(1, 1 << 16, (256, 8)).astype(
        np.uint32)
    run, _ = po.make_kernel(PROBE_OPS[op], jnp.uint32, 2)
    want = t32(run(jnp.asarray(x))).reshape(-1)
    got = probe_ref.raw_chain(op, t32(x).reshape(-1), 16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["wide", "split16", "narrow1", "empty"])
def test_layout_chain_matches_layout_probe_body(variant):
    """layout_probe's kernel body on (256, 8) for 16 iterations; narrow1
    and empty chain the first 16 rows (1/16 of the elements)."""
    lp = tpu_script("layout_probe")
    x = np.random.RandomState(0).randint(0, 1 << 16, (256, 8)).astype(
        np.uint32)
    f = pl.pallas_call(
        lp.make(variant, 8, 16),
        out_shape=jax.ShapeDtypeStruct((256, 8), jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    want = t32(f(jnp.asarray(x)))
    rows = 16 if variant in ("narrow1", "empty") else 256
    op = "empty" if variant == "empty" else "layout"
    got = probe_ref.raw_chain(op, t32(x[:rows]).reshape(-1), 16)
    assert torch.equal(got, want[:rows].reshape(-1))


# ---- P3: walk variants vs scripts/pkdelta.py ----

def _pkdelta_body(variant, nb_run, state, tabs, masks):
    """pkdelta's kernel body in interpret mode, one block of all lanes."""
    pd = tpu_script("pkdelta")
    n = state[0].shape[1]
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0, 0))  # noqa: E731
    f = pl.pallas_call(
        pd.make_kernel(variant, nb_run), grid=(1,),
        out_shape=tuple(jax.ShapeDtypeStruct((r, n), jnp.uint32)
                        for r in (16, 16, 8, 1)),
        in_specs=[full((16, 32)), full((16, 32)), full((8, 32)),
                  full((1, 4)), full((16, n)), full((16, n)),
                  full((8, n))],
        out_specs=tuple(full((r, n)) for r in (16, 16, 8, 1)),
        interpret=True)
    return f(*(jnp.asarray(t) for t in tabs), jnp.asarray(masks)[None, :],
             *(jnp.asarray(s) for s in state))


@pytest.mark.parametrize("variant", ["base", "no_sqr", "no_y3mul",
                                     "fixed_gather"])
def test_delta_walk_matches_pkdelta_body(variant):
    """pkdelta's body at n = 256 (grid 1, its inv_stop 128) for 2 steps,
    dp 2 so that lanes count hits: px, d and count bit-equal, py mod p."""
    rs = np.random.RandomState(3)
    n, nb_run = 256, 2
    state = [rand_limbs(rs, r, n) for r in (16, 16, 8)]
    tabs = [rand_limbs(rs, r, 32) for r in (16, 16, 8)]
    masks = jref.dp_limb_masks(2)
    px, py, d, cnt = _pkdelta_body(variant, nb_run, state, tabs, masks)
    got = probe_ref.delta_walk(variant, *map(t32, state), *map(t32, tabs),
                               t32(masks), nb_run, 2)
    assert torch.equal(got[0], t32(px))
    assert torch.equal(canon(got[1]), canon(t32(py)))
    assert torch.equal(got[2], t32(d))
    assert torch.equal(got[3], t32(cnt)[0])
    assert int(got[3].sum()) > 0


def test_delta_base_is_the_plain_walk():
    """`base` is the production walk: jump_ref.jump_steps_with_dp."""
    rs = np.random.RandomState(4)
    n = 256
    state = [t32(rand_limbs(rs, r, n)) for r in (16, 16, 8)]
    tabs = [t32(rand_limbs(rs, r, 32)) for r in (16, 16, 8)]
    masks = jump_ref.dp_limb_masks(3)
    got = probe_ref.delta_walk("base", *state, *tabs, masks, 6, 2)
    want = jump_ref.jump_steps_with_dp(*state, *tabs, masks, nb_run=6,
                                       slots=2)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(canon(g) if i == 1 else g,
                           canon(w) if i == 1 else w)


# ---- P4: inversion chains vs scripts/pkinv.py ----

@pytest.mark.parametrize("variant", ["cur", "nodiv", "none"])
def test_inv_chain_matches_pkinv_sequence(variant):
    """pkinv's chain x <- (fn(x) - x) | 1 with canonicalize inserted
    before the | 1 (its body ors a relaxed value), fn its own variant
    (batch_inv at stop=128) on (16, 256) for 2 iterations: the fold
    tree's groups at 256 lanes are the kernel's at G = 2."""
    pi = tpu_script("pkinv")
    x = (np.random.RandomState(0).randint(0, 1 << 16, (16, 256)) | 1).astype(
        np.uint32)
    fn = pi.VARIANTS[variant]

    @jax.jit
    def body(v):
        return jfield.canonicalize(jfield.submod(fn(v), v)) | jnp.uint32(1)

    want = jnp.asarray(x)
    for _ in range(2):
        want = body(want)
    got = probe_ref.inv_chain(variant, t32(x), 2, group=2)
    assert torch.equal(got, t32(want))


# ---- the kernels' own bodies (g++) vs the plain versions ----

@pytest.mark.parametrize("op", probe_ref.FIELD_OPS)
def test_host_field_chain_matches_plain(lib, op):
    """kt_field_chain's body: 256 lanes x 3 rounds (the step on one
    block of the walk's geometry x 2 rounds)."""
    rs = np.random.RandomState(21)
    n = jump_cuda.LANE_QUANTUM if op == "step" else 256
    rounds = 2 if op == "step" else 3
    a, b = t32(rand_limbs(rs, 16, n)), t32(rand_limbs(rs, 16, n))
    jx, jy = t32(rand_limbs(rs, 16, 32)), t32(rand_limbs(rs, 16, 32))
    got = host_kernel.field_chain(op, a.clone(), b, rounds, jx, jy)
    want = probe_ref.field_chain(op, a, b, rounds, jx, jy)
    if op in ("gather", "step"):
        assert torch.equal(got, want)
    else:
        assert torch.equal(canon(got), canon(want))


RAW_CASES = [(op, ilp) for op in probe_ref.RAW_OPS
             for ilp in ((1, 2, 4, 16) if op == "layout"
                         else (1,) if op == "empty" else (4,))]


@pytest.mark.parametrize("op,ilp", RAW_CASES)
def test_host_raw_chain_matches_plain(lib, op, ilp):
    """kt_raw_chain's body on 1024 elements x 64 iterations."""
    rs = np.random.RandomState(5)
    if op in probe_ref.F32_OPS:
        x = torch.from_numpy(rs.uniform(1.0, 2.0, 1024).astype(np.float32))
    else:
        x = t32(rs.randint(1, 1 << 16, 1024).astype(np.uint32))
    got = host_kernel.raw_chain(op, x.clone(), 64, ilp)
    want = probe_ref.raw_chain(op, x, 64)
    if op in probe_ref.F32_OPS:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, want)


def _walk_inputs(seed, n):
    rs = np.random.RandomState(seed)
    state = [t32(rand_limbs(rs, r, n)) for r in (16, 16, 8)]
    tabs = [torch.from_numpy(t.astype(np.int32))
            for t in create_jump_table(64).as_arrays()]
    return state, tabs


# every (variant, G) the probe kernels build: the walk kernels' G keeps
# the plain variant ids
DELTA_CASES = [pytest.param(v, g, id=v if g == jump_cuda.GROUP
                            else f"{v}-G{g}")
               for v in probe_ref.DELTA_VARIANTS
               for g in probe_cuda.DELTA_GROUPS[v]]


@pytest.mark.parametrize("variant,group", DELTA_CASES)
def test_host_delta_walk_matches_plain(lib, variant, group):
    """kt_delta_kernel's body (walk_thread with the variant type) at the
    kernel's real geometry and its G, one block x 3 steps, dp 3 with 2
    slots so that lanes overflow: px, d, count and every slot bit-equal,
    py mod p."""
    n = jump_cuda.THREADS * group
    state, tabs = _walk_inputs(9, n)
    masks = jump_ref.dp_limb_masks(3)
    got = host_kernel.delta_walk(variant, *[t.clone() for t in state],
                                 *tabs, masks, 3, 2, group)
    want = probe_ref.delta_walk(variant, *state, *tabs, masks, 3, 2)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(canon(g) if i == 1 else g,
                           canon(w) if i == 1 else w), i
    assert (int(got[3].sum()) > 0) == (variant != "no_dp")


@pytest.mark.parametrize("variant,group", [
    ("base", 16), ("base", 256), ("no_sqr", 32), ("no_inv", 128)])
def test_host_delta_walk_refuses_a_g_it_is_not_built_for(lib, variant,
                                                         group):
    """The body's builds (walk.cuh with_group, probes.cuh
    delta_has_group) are the G that DELTA_GROUPS lists: a variant at
    another G is refused, not run at the wrong G."""
    assert group not in probe_cuda.DELTA_GROUPS[variant]
    state, tabs = _walk_inputs(11, jump_cuda.THREADS * group)
    with pytest.raises(ValueError, match="refused"):
        host_kernel.delta_walk(variant, *state, *tabs,
                               jump_ref.dp_limb_masks(3), 1, 2, group)


def test_host_delta_base_is_the_production_body(lib):
    """walk_thread<false, Production> through the probe entry point is
    the walk kernel's body through kt_walk_host, bit for bit."""
    n = jump_cuda.LANE_QUANTUM
    state, tabs = _walk_inputs(10, n)
    masks = jump_ref.dp_limb_masks(4)
    got = host_kernel.delta_walk("base", *[t.clone() for t in state],
                                 *tabs, masks, 4, 3)
    want = host_kernel.walk(*[t.clone() for t in state], *tabs, masks,
                            nb_run=4, slots=3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_build_shared_parts_links_every_part(tmp_path, monkeypatch):
    """The probe library's build: one source compiled once per part, all
    at once, and linked into one library; a failing part raises and
    leaves nothing behind."""
    import ctypes

    from kangaroo_torch.utils import build

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = tmp_path / "out"
    monkeypatch.setattr(build, "BUILD_DIR", out)
    src = tmp_path / "parts.c"
    src.write_text("#if PART == 0\nint part0(void) { return 10; }\n"
                   "#else\nint part1(void) { return 11; }\n#endif\n")
    cmd, link = ["g++", "-x", "c", "-fPIC", "-O1"], ["g++", "-shared"]
    path = build.build_shared_parts(
        "libparts.so", src, [["-DPART=0"], ["-DPART=1"]], cmd, link)
    so = ctypes.CDLL(str(path))
    assert (so.part0(), so.part1()) == (10, 11)
    assert sorted(p.name for p in out.iterdir()) == ["libparts.so",
                                                     "libparts.so.log"]
    with pytest.raises(RuntimeError, match="build of libbad.so failed"):
        build.build_shared_parts(
            "libbad.so", src,
            [["-DPART=0"], ["-DPART=1", "-include", "missing.h"]], cmd, link)
    assert sorted(p.name for p in out.iterdir()) == ["libparts.so",
                                                     "libparts.so.log"]


@pytest.mark.parametrize("blocks", [128, 1])
def test_smoke_group_sample_keeps_the_kernels_groups(lib, blocks):
    """chip_smoke.py's sample of whole thread groups, fed to the plain
    inversion chain, forms the groups the kernel body formed (nodiv's
    R^2 / x depends on every lane of its group), and holds the thread of
    a lane it was asked for."""
    import chip_smoke

    g = 32
    rs = np.random.RandomState(6)
    x = t32(rand_limbs(rs, 16, blocks * 128 * g) | 1)
    want = x.shape[1] // 2 + 77
    got = host_kernel.inv_chain("nodiv", x.clone(), 1, g)
    idx = torch.from_numpy(chip_smoke._group_sample(blocks, g, rs, [want]))
    assert idx.numel() == max(blocks, 128) * g
    assert bool((idx == want).any())
    assert torch.equal(got[:, idx],
                       probe_ref.inv_chain("nodiv", x[:, idx], 1, g))


@pytest.mark.parametrize("variant,group", [
    ("cur", 32), ("cur", 128), ("cur", 256), ("nodiv", 32),
    ("nodiv", 128), ("none", jump_cuda.GROUP)])
def test_host_inv_chain_matches_plain(lib, variant, group):
    """kt_inv_chain's body on one block of its G (128 G lanes) x 2
    iterations."""
    rs = np.random.RandomState(group)
    x = t32(rand_limbs(rs, 16, 128 * group) | 1)
    got = host_kernel.inv_chain(variant, x.clone(), 2, group)
    want = probe_ref.inv_chain(variant, x, 2, group)
    assert torch.equal(got, want)
