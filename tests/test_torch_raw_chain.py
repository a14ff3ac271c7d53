"""P2's raw chains (`kt_raw_chain`) on the CPU: the unrolled body, the
shift-and-add primitive, the bounds by one rule, and the occupancy that
the contrast rows hold.

The kernel body (csrc/probes.cuh raw_chain_thread: trips of RAW_TRIP
element-iterations of a thread unrolled, then the rest one at a time;
the layout chain's index i + 1 folded into its xor as base ^ (j + 1);
shr16's shift-and-add as mulhi_add, hi32(a * 2^16) + u) is built with
g++ (host_shim.cpp) and held bit-equal to the plain chains and to the
TPU probes' own bodies (scripts/probe_ops.py, scripts/layout_probe.py in
Pallas interpret mode, as tests/test_torch_probes.py runs them) at
iteration counts that run whole trips and a remainder.  The kernels
themselves run in tests/test_torch_cuda.py (card only).
"""

import functools
import re
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

from kangaroo_torch.ops import host_kernel, probe_cuda, probe_ref  # noqa: E402
from kangaroo_torch.probes import common, layout_probe  # noqa: E402
from tests.test_torch_probes import t32, tpu_script  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "kangaroo_torch" / "csrc"
PEAK_ALU = 16.75e12   # 64 a clock an SM x 132 SMs x the derived clock
PEAK_ISSUE = 33.5e12  # 128 a clock an SM


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: cannot build csrc/ for the host")
    return host_kernel.load()


def header_constant(name: str) -> int:
    """An integer constexpr of csrc/probes.cuh: n, or n << m."""
    m = re.search(rf"constexpr (?:int|uint32_t) {name} = (\d+)u?"
                  rf"(?: << (\d+))?;", (CSRC / "probes.cuh").read_text())
    assert m, name
    return int(m.group(1)) << int(m.group(2) or 0)


def unroll(ilp: int) -> int:
    """Iterations a trip of the chain's loop holds at ILP ilp."""
    return probe_cuda.RAW_TRIP // ilp


# ---- the unrolled body against the plain chains ----

RAW_CASES = [(op, ilp) for op in probe_ref.RAW_OPS
             for ilp in probe_cuda.RAW_ILPS[op]]


@pytest.mark.parametrize("op,ilp", RAW_CASES)
def test_unrolled_body_matches_plain(lib, op, ilp):
    """Every instantiation on 512 elements: 2 whole trips and 5 more
    iterations (the loop after the trips), and fewer iterations than one
    trip (that loop alone); integers bit-equal, f32 within rtol 1e-5."""
    rs = np.random.RandomState(13)
    n = 512
    if op in probe_ref.F32_OPS:
        x = torch.from_numpy(rs.uniform(1.0, 2.0, n).astype(np.float32))
    else:
        x = t32(rs.randint(0, 1 << 16, n).astype(np.uint32))
    for inner in (2 * unroll(ilp) + 5, unroll(ilp) - 1):
        got = host_kernel.raw_chain(op, x.clone(), inner, ilp)
        want = probe_ref.raw_chain(op, x, inner)
        if op in probe_ref.F32_OPS:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        else:
            assert torch.equal(got, want), (op, ilp, inner)


@pytest.mark.parametrize("variant", ["wide", "tall", "outer3d", "split16",
                                     "narrow1", "empty"])
def test_unrolled_layout_matches_layout_probe_body(lib, variant):
    """layout_probe's TPU kernel body (interpret mode) on (256, 8) for one
    trip of the variant's ILP and 3 more iterations, against the g++
    body at that ILP: the index folded into the xor is i + 1."""
    ilp = layout_probe.VARIANTS[variant][0]
    iters = unroll(ilp) + 3
    lp = tpu_script("layout_probe")
    x = np.random.RandomState(3).randint(0, 1 << 16, (256, 8)).astype(
        np.uint32)
    f = pl.pallas_call(
        lp.make(variant, 8, iters),
        out_shape=jax.ShapeDtypeStruct((256, 8), jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    want = t32(f(jnp.asarray(x)))
    rows = 16 if variant in ("narrow1", "empty") else 256
    op = "empty" if variant == "empty" else "layout"
    got = host_kernel.raw_chain(op, t32(x[:rows]).reshape(-1).clone(),
                                iters, ilp)
    assert torch.equal(got, want[:rows].reshape(-1))


@pytest.mark.parametrize("op", probe_ref.SHR16_OPS)
def test_shr16_forms_match_probe_ops_body(lib, op, monkeypatch):
    """probe_ops' TPU kernel body for shr16 ((a >> 16) + i, interpret
    mode) on (256, 8) for one trip and 5 more iterations, against each
    of the three kernels' g++ body (mulhi_add by 2^16 on every chain)."""
    iters = unroll(4) + 5
    po = tpu_script("probe_ops")
    monkeypatch.setattr(po, "ROWS", 256)
    monkeypatch.setattr(po, "COLS", 8)
    monkeypatch.setattr(po, "INNER", iters)
    monkeypatch.setattr(po, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    x = np.random.RandomState(4).randint(1, 1 << 16, (256, 8)).astype(
        np.uint32)
    run, _ = po.make_kernel(lambda a, b, i: (a >> 16) + i, jnp.uint32, 2)
    want = t32(run(jnp.asarray(x))).reshape(-1)
    got = host_kernel.raw_chain(op, t32(x).reshape(-1).clone(), iters, 4)
    assert torch.equal(got, want)


EDGE = np.array([0, 1, (1 << 16) - 1, (1 << 32) - 1], dtype=np.uint64)


def test_mulhi_add_twin_on_edge_words(lib):
    """mulhi_add's host twin, hi32(a * b) + c mod 2^32, on every triple
    of edge words (0, 1, 2^16 - 1, 2^32 - 1) and at b = 2^16, where it
    is (a >> 16) + c."""
    a, b, c = (v.reshape(-1) for v in np.meshgrid(EDGE, EDGE, EDGE))
    got = host_kernel.mulhi_add(a, b, c)
    want = ((a * b) >> np.uint64(32)) + c
    assert np.array_equal(got, (want & 0xFFFFFFFF).astype(np.uint32))
    a, c = (v.reshape(-1) for v in np.meshgrid(EDGE, EDGE))
    m = np.full(a.shape, header_constant("SHR_MUL"), dtype=np.uint64)
    got = host_kernel.mulhi_add(a, m, c)
    assert np.array_equal(got, (((a >> np.uint64(16)) + c) & 0xFFFFFFFF)
                          .astype(np.uint32))


def test_xor3_twin_on_edge_words(lib):
    """xor3's host twin, a ^ b ^ c, on every triple of edge words, and
    the layout trip's use of it: a ^ (base ^ (j + 1)) is a ^ (i + 1) at
    i = base + j, base a multiple of the trip's length."""
    a, b, c = (v.reshape(-1) for v in np.meshgrid(EDGE, EDGE, EDGE))
    assert np.array_equal(host_kernel.xor3(a, b, c),
                          (a ^ b ^ c).astype(np.uint32))
    u = unroll(1)
    base = np.arange(0, 4 * u, u, dtype=np.uint64)
    j = np.arange(u - 1, dtype=np.uint64)
    bb, jj = (v.reshape(-1) for v in np.meshgrid(base, j))
    aa = np.full(bb.shape, 0xDEADBEEF, dtype=np.uint64)
    assert np.array_equal(host_kernel.xor3(aa, bb, jj + 1),
                          (aa ^ (bb + jj + 1)).astype(np.uint32))


def test_mulhi_add_twin_random(lib):
    """The twin on 4096 random triples against numpy's 64-bit product."""
    rs = np.random.RandomState(9)
    a, b, c = (rs.randint(0, 1 << 32, 4096, dtype=np.uint64)
               for _ in range(3))
    want = (((a * b) >> np.uint64(32)) + c) & 0xFFFFFFFF
    assert np.array_equal(host_kernel.mulhi_add(a, b, c),
                          want.astype(np.uint32))


def test_trip_constants_match_the_header():
    """The bounds' trip and the kernels' (probes.cuh), and the shr16
    split the docs name, read from the header."""
    assert probe_cuda.RAW_TRIP == header_constant("RAW_TRIP") == 128
    assert header_constant("SHR_MUL") == 1 << 16
    assert 0 < header_constant("SHR16_MIX_CHAINS") < probe_cuda.RAW_PROBE_ILP
    assert all(probe_cuda.RAW_TRIP % ilp == 0
               for ilps in probe_cuda.RAW_ILPS.values() for ilp in ilps)


# ---- the bounds by the rule ----

@pytest.mark.parametrize("op", ["u32_add", "u32_mul", "mask16", "shr16",
                                "i32_mul", "f32_add", "wide"])
def test_probe_ops_rows_count_the_index_at_one_over_ilp(op):
    """A probe_ops row adds the loop index to a term: one add an
    iteration shared by the 4 chains, 1/4 "int" an element-iteration
    beyond its ops (the f32 rows' mix also a conversion and two fp32
    ops, 1/4 each)."""
    c = probe_cuda.RAW_COUNTS[op]
    ix = 1 / probe_cuda.RAW_PROBE_ILP
    assert ix == 0.25
    if op.startswith("f32"):
        assert c == {"fp32": 3 + 2 * ix, "int": 2 * ix}
    else:
        assert c["int"] % 1 == pytest.approx(ix)


def test_layout_index_costs_nothing():
    """The layout chain's index enters its xor: folded into the LOP3's
    immediate, it is not counted; the bound is the LOP3 and the IMAD,
    issue-bound: 2^37 x 2 / 33.5e12 s."""
    assert probe_cuda.RAW_COUNTS["layout"] == {"imad": 1, "alu": 1}
    ms, by = probe_cuda.bound_ms(probe_cuda.RAW_COUNTS["layout"], 2 ** 37,
                                 8 * 2 ** 20)
    assert by == "operations"
    assert ms == pytest.approx(2 ** 37 * 2 / PEAK_ISSUE * 1e3)


@pytest.mark.parametrize("counts,ms_per_1e6", [
    # u32_mul: IMAD, LOP3 and the index's 1/4: 2.25 issue slots bind
    ({"imad": 1, "alu": 1, "int": 0.25}, 2.25 / PEAK_ISSUE * 1e9),
    # a shift-and-add alone (fused): 2/3 as LEA.HI, 2/3 ALU slots
    ({"fused": 1}, 2 / 3 / PEAK_ALU * 1e9),
    # shr16: half a LOP3, the shift-and-add, the index's 1/4: 13/12 ALU
    # slots (7/12 of the shift-and-adds as LEA.HI)
    ({"alu": 0.5, "fused": 1, "int": 0.25}, 13 / 12 / PEAK_ALU * 1e9),
    # IMAD.WIDE: two IMAD slots, one issue slot
    ({"imad2": 1, "int": 1.25, "alu": 1}, 2 / PEAK_ALU * 1e9),
    # the same with two more adds: now 5.25 issue slots bind
    ({"imad2": 1, "int": 3.25, "alu": 1}, 5.25 / PEAK_ISSUE * 1e9),
    # counted as two IMAD instructions it would read 6.25 slots
    ({"imad": 2, "int": 3.25, "alu": 1}, 6.25 / PEAK_ISSUE * 1e9),
])
def test_bound_ms_by_hand(counts, ms_per_1e6):
    """bound_ms on 10^6 element-iterations, worked by hand."""
    ms, by = probe_cuda.bound_ms(counts, 10 ** 6, 0)
    assert by == "operations"
    assert ms == pytest.approx(ms_per_1e6)


@pytest.mark.parametrize("op,alu_slots", [
    # every shift-and-add an IMAD.HI: two IMAD slots bind (the ALU pipe
    # holds only the half LOP3)
    ("shr16_hi", 2),
    # one chain of four on IMAD.HI (2 x 1/4 IMAD slots), three on LEA.HI:
    # the ALU pipe binds at 1/2 + 3/4
    ("shr16_mix", 1.25),
    # the function itself at its best mix
    ("shr16", 13 / 12),
])
def test_shr16_contrasts_count_the_forms_they_hold(op, alu_slots):
    """shr16's contrast rows are held to a form (all IMAD.HI, or one
    chain of four), and their bounds count it; shr16's is the
    function's: 2^37 element-iterations."""
    ms, _ = probe_cuda.bound_ms(probe_cuda.RAW_COUNTS[op], 2 ** 37, 0)
    assert ms == pytest.approx(2 ** 37 * alu_slots / PEAK_ALU * 1e3)


def test_narrow1_and_empty_are_bound_by_their_latency_floor():
    """narrow1 (2^16 chains, 2^17 steps) needs 2^34 slots: 0.5128 ms at
    the issue rate, but 2^16 threads are 3.9 warps a scheduler, and a
    step takes LOP3 and IMAD latency in turn: at 10.5 clocks a step at
    1.98 GHz the chain takes 0.695 ms, which is its bound.  empty's
    operations are 4 slots a trip of 128 iterations (8.0 us); its
    floor is its trips' latency."""
    ops, _ = probe_cuda.bound_ms(probe_cuda.RAW_COUNTS["layout"],
                                 2 ** 33, 8 * 2 ** 16)
    assert ops == pytest.approx(2 ** 34 / PEAK_ISSUE * 1e3)
    assert ops == pytest.approx(0.5128, abs=1e-4)
    lat = 2 ** 17 * 10.5 / 1.98e9 * 1e3
    assert lat == pytest.approx(0.695, abs=1e-3)
    assert max(ops, lat) == lat
    empty, _ = probe_cuda.bound_ms(probe_cuda.RAW_COUNTS["empty"], 2 ** 33,
                                   8 * 2 ** 16)
    assert empty == pytest.approx(2 ** 33 * 4 / 128 / PEAK_ISSUE * 1e3)
    assert layout_probe.LATENCY_OF == {"narrow1": "narrow1_lat",
                                       "empty": "empty_lat"}


def test_latency_rows_run_one_warp_a_scheduler():
    """The latency runs take one block of 128 threads an SM: 4 warps an
    SM, one a scheduler, at ILP 1."""
    for v in layout_probe.LATENCY_OF.values():
        assert layout_probe.VARIANTS[v][0] == 1
        assert layout_probe.elements(v, layout_probe.W, 132) == 132 * 128
    assert layout_probe.elements("narrow1", layout_probe.W, 132) == 1 << 16
    assert layout_probe.elements("wide", layout_probe.W, 132) == 1 << 20


# ---- the occupancy of the contrast rows ----

@pytest.mark.parametrize("blocks", [1, 2, 3, 4, 8])
def test_contrast_smem_holds_a_stated_occupancy(blocks):
    """The shared memory that holds a kernel to `blocks` blocks an SM:
    that many blocks fit the SM's 228 KB (1 KB kept for each), one more
    does not, with or without 4 KB of static shared memory."""
    for static in (0, 4096):
        smem = common.occupancy_smem(blocks, static)
        per = smem + static + common.SMEM_RESERVED
        assert common.SMEM_PER_SM // per == blocks
    assert common.occupancy_smem(4) == 57344


def test_walk_occupancy_label():
    """The walk kernel's launch bounds ask for 4 blocks of 128 threads an
    SM: 4 warps a scheduler, as the contrast rows say."""
    assert common.walk_label(4) == \
        "@walk occupancy (4 blocks/SM, 4 warps a scheduler)"
    with pytest.raises(ValueError):
        common.occupancy_smem(0)
