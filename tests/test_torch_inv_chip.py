"""P4's on-chip form (`kt_inv_chip`) on the CPU: its g++-built body, its
lane sets and its bound.

The on-chip kernel keeps each thread's G lanes and prefix products in
shared memory for the whole launch; its body (csrc/probes.cuh
inv_chip_thread) is built with g++ (host_shim.cpp) and held bit-equal
against the plain chain over its lane sets, whose grouping is held
against the TPU probe's own fold tree (scripts/pkinv.py, run as
tests/test_torch_probes.py runs it).  Field values are canonical after
every iteration, so every comparison is exact.  The kernel itself runs
in tests/test_torch_cuda.py (card only).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kangaroo_tpu.ops import field as jfield  # noqa: E402
from kangaroo_torch.ops import (  # noqa: E402
    host_kernel, jump_cuda, probe_cuda, probe_ref)
from tests.test_torch_probes import t32, tpu_script  # noqa: E402

THREADS = probe_cuda.THREADS


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: cannot build csrc/ for the host")
    return host_kernel.load()


def odd_limbs(seed, n):
    rs = np.random.RandomState(seed)
    return t32(rs.randint(0, 1 << 16, (16, n)).astype(np.uint32) | 1)


@pytest.mark.parametrize("group", probe_cuda.CHIP_GROUPS)
@pytest.mark.parametrize("variant", probe_ref.INV_VARIANTS)
def test_host_inv_chip_matches_plain(lib, variant, group):
    """kt_inv_chip's body on two blocks of its G x 3 iterations against
    the plain chain over the kernels' lane sets: bit-equal."""
    n = 2 * THREADS * group
    x = odd_limbs(group, n)
    got = host_kernel.inv_chip(variant, x.clone(), 3, group)
    want = probe_ref.inv_chain(variant, x, 3,
                               sets=probe_ref.lane_sets(n, group))
    assert torch.equal(got, want)


@pytest.mark.parametrize("group", probe_cuda.CHIP_GROUPS)
def test_chip_cur_equals_walk_layout_cur(lib, group):
    """cur's output is each lane's inverse chain whatever the grouping:
    the on-chip form's at G 16, 32 (runs of 8 lanes) equals the walk
    layout's at its G 64 on the same 16384 lanes, the plain chains and
    the g++-built bodies alike."""
    n = 16384
    x = odd_limbs(3, n)
    chip = probe_ref.inv_chain("cur", x, 2, group)
    walk = probe_ref.inv_chain("cur", x, 2, 64)
    assert torch.equal(chip, walk)
    body = host_kernel.inv_chip("cur", x.clone(), 2, group)
    assert torch.equal(body, host_kernel.inv_chain("cur", x.clone(), 2, 64))
    assert torch.equal(body, chip)


def test_chip_nodiv_equals_walk_layout_nodiv_at_one_g(lib):
    """At G 32 both forms invert the same lane sets, so nodiv (whose
    output depends on the sets) agrees between them: the on-chip body's
    4 runs of 8 lanes against the walk layout's one chain of 32."""
    x = odd_limbs(4, 2 * THREADS * 32)
    assert torch.equal(host_kernel.inv_chip("nodiv", x.clone(), 3, 32),
                       host_kernel.inv_chain("nodiv", x.clone(), 3, 32))


@pytest.mark.parametrize("variant", probe_ref.INV_VARIANTS)
def test_chip_lane_sets_match_pkinv_fold_tree(variant):
    """The on-chip form's lane sets at G 16 (thread t of the block owns
    lanes g*128 + t) against scripts/pkinv.py's own variant, whose fold
    tree (batch_inv at stop=128) on 2048 lanes inverts lanes t + 128k,
    k < 16, together: 2 iterations of the chain, canonicalize inserted
    before the | 1 as in test_torch_probes.py's pkinv test."""
    pi = tpu_script("pkinv")
    g, n = 16, 16 * THREADS
    x = odd_limbs(11, n)
    fn = pi.VARIANTS[variant]

    @jax.jit
    def body(v):
        return jfield.canonicalize(jfield.submod(fn(v), v)) | jnp.uint32(1)

    want = jnp.asarray(x.numpy().view(np.uint32))
    for _ in range(2):
        want = body(want)
    got = probe_ref.inv_chain(variant, x, 2,
                              sets=probe_ref.lane_sets(n, g))
    assert torch.equal(got, t32(want))


def test_plain_chain_refuses_sets_that_miss_lanes():
    x = odd_limbs(1, 2 * THREADS * 8)
    sets = probe_ref.lane_sets(x.shape[1], 8)
    sets[0, 0] = sets[0, 1]
    with pytest.raises(ValueError, match="each of"):
        probe_ref.inv_chain("cur", x, 1, sets=sets)
    with pytest.raises(ValueError, match="power of two"):
        probe_ref.inv_chain("cur", x[:, :768], 1,
                            sets=torch.arange(768).reshape(-1, 6))
    with pytest.raises(ValueError, match="multiple"):
        probe_ref.lane_sets(1000, 8)


# ---- the bound with the ALU pipe ----

def test_bound_ms_reads_alu_at_its_pipe():
    """Hand-worked: the peaks are 64 IMAD and 64 ALU-pipe instructions,
    128 issue slots an SM and clock, 64 x 132 x clock = IMAD_PEAK =
    16.75e12/s.  P4 none's function on 2^28 lane-iterations (the walk
    layout's none): two fe_sub and an fe_canon, carry chains of 44 "int"
    slots, and the | 1's 8 LOP3 on the ALU pipe: 52 slots on the issue
    rate, 2^28 x 52 / 33.5e12 s = 0.416675 ms.  "int" counts against the
    issue rate only; the slowest class binds; bytes bind where they are
    slower."""
    assert jump_cuda.IMAD_PEAK == 16.75e12
    assert probe_cuda.inv_counts("none", 64) == {"alu": 8, "int": 44}
    ms, by = probe_cuda.bound_ms(probe_cuda.inv_counts("none", 64),
                                 1 << 28, 0)
    assert by == "operations"
    assert ms == pytest.approx(268435456 * 52 / 33.5e12 * 1e3)
    assert ms == pytest.approx(0.416675, abs=1e-6)
    # 2000 int slots: on the issue rate (2 x IMAD_PEAK), 1e6 lanes
    ms, _ = probe_cuda.bound_ms({"int": 2000}, 10 ** 6, 0)
    assert ms == pytest.approx(2000e6 / 33.5e12 * 1e3)
    # imad 100 and alu 60 on their own pipes, 160 slots on the issue
    # rate: the IMAD pipe is the slowest (100 / 64 > 160 / 128)
    ms, _ = probe_cuda.bound_ms({"imad": 100, "alu": 60}, 10 ** 6, 0)
    assert ms == pytest.approx(100e6 / 16.75e12 * 1e3)
    # alu 100 and imad 20: the ALU pipe (100 / 64 > 120 / 128)
    ms, _ = probe_cuda.bound_ms({"imad": 20, "alu": 100}, 10 ** 6, 0)
    assert ms == pytest.approx(100e6 / 16.75e12 * 1e3)
    # 64 MB at 3.35 TB/s beside 1 ALU slot a lane
    ms, by = probe_cuda.bound_ms({"alu": 1}, 10 ** 6, 64e6)
    assert (ms, by) == (pytest.approx(64e6 / 3.35e12 * 1e3), "bytes")


@pytest.mark.parametrize("counts,alu_slots", [
    # u32_add: a LOP3 and a + b + u (one IADD3, or two adds): a third of
    # the adds as IADD3, 4/3 ALU slots and 2 x 2/3 on the other pipe
    ({"alu": 1, "fused": 1}, 4 / 3),
    # shr16: 2/7 LOP3 and the shift and add (one LEA.HI, or two slots):
    # 4/7 as LEA.HI, 6/7 ALU slots
    ({"alu": 2 / 7, "fused": 1}, 6 / 7),
    # the fused op alone: 2/3 of it on the ALU pipe
    ({"fused": 3}, 2),
    # the ALU pipe already the slowest: the fused op goes as two slots
    # elsewhere, and the ALU pipe binds (10 against 13 issue slots / 2)
    ({"alu": 10, "fused": 1, "int": 1}, 10),
])
def test_bound_ms_fused_at_its_best_mix(counts, alu_slots):
    """A fused op (one ALU-pipe instruction, or two slots on either
    pipe) at the mix where the ALU pipe and the issue rate meet, or at
    the end of its range: the bound in ALU-slot times at 16.75e12/s."""
    ms, by = probe_cuda.bound_ms(counts, 10 ** 6, 0)
    assert by == "operations"
    assert ms == pytest.approx(alu_slots * 1e6 / 16.75e12 * 1e3)


@pytest.mark.parametrize("op,ms", [
    # u32_add at 2^20 x 2^17: the xor, a + b + u (fused) and the index
    # add shared by 4 chains (1/4 "int"): 17/12 ALU slots an
    # element-iteration (5/12 of the fused op as IADD3), where the ALU
    # pipe meets the issue rate
    ("u32_add", 2 ** 37 * 17 / 12 / 16.75e12 * 1e3),
    # mask16: 1.5 LOP3 on the ALU pipe, the adds anywhere
    ("mask16", 2 ** 37 * 1.5 / 16.75e12 * 1e3),
    # shr16: half a LOP3 (b's xors, two a three-input LOP3), the
    # shift-and-add (fused: LEA.HI, or two slots) and the index's 1/4:
    # 13/12 ALU slots (7/12 of the shift-and-adds as LEA.HI)
    ("shr16", 2 ** 37 * 13 / 12 / 16.75e12 * 1e3),
    # wide: IMAD.WIDE's two IMAD slots bind (one issue slot)
    ("wide", 2 ** 37 * 2 / 16.75e12 * 1e3),
])
def test_raw_bounds_by_the_rule(op, ms):
    """P2's bounds under the one rule (probe_cuda's peaks comment):
    logic and shifts on the ALU pipe, adds on either pipe, fused ops at
    their best mix."""
    got, _ = probe_cuda.bound_ms(probe_cuda.RAW_COUNTS[op], 2 ** 37,
                                 8 * 2 ** 20)
    assert got == pytest.approx(ms)


def test_carry_chains_count_on_either_pipe():
    """Every carry chain counts "int": the add-class field ops, the
    chain's step and P4 none keep no ALU-only slot but the | 1's LOP3;
    fe_sub's 18 words at the issue rate on 2^22 x 256 lane-rounds is
    0.577 ms."""
    for op in ("sub", "add", "fold", "canon"):
        assert "alu" not in probe_cuda.FIELD_COUNTS[op]
    assert probe_cuda.STEP == {"alu": 8, "int": 26}
    ms, _ = probe_cuda.bound_ms(probe_cuda.FIELD_COUNTS["sub"],
                                2 ** 22 * 256, 3 * 64 * 2 ** 22)
    assert ms == pytest.approx(2 ** 30 * 18 / 33.5e12 * 1e3)
    assert ms == pytest.approx(0.577, abs=5e-4)


def test_chip_counts_and_traffic(lib):
    """The on-chip form's design count is the function's with its
    shared-memory words, at the run length read from the library (the
    g++ build of the same probes.cuh); its device traffic is one read
    and one write of 64 B a lane per launch, the walk layout's 128 or
    256 B a lane and iteration."""
    from kangaroo_torch.probes import pkinv

    run = host_kernel.chip_run()
    assert run == 8
    assert all(g % run == 0 for g in probe_cuda.CHIP_GROUPS)
    f = probe_cuda.inv_counts("cur", 32)
    assert f["imad"] == pytest.approx(
        (3 * 31 * jump_cuda.MUL_IMAD + jump_cuda.INV_IMAD) / 32)
    assert f["int"] == pytest.approx(26 + probe_cuda.INV_ALU / 32)
    assert f["alu"] == 8
    # per lane: x loaded twice and stored once (24 words), the prefix
    # stored for 6 and loaded for 7 of a run's 8 lanes (13 x 8 / 8)
    assert probe_cuda.inv_chip_counts("cur", 32, run) == dict(f, lds=37)
    assert probe_cuda.inv_chip_counts("none", 32, run) == {
        "alu": 8, "int": 44, "lds": 16}
    assert pkinv.traffic_bytes("chip", "cur", 64) == 128
    assert pkinv.traffic_bytes("walk", "cur", 64) == 64 * 256
    assert pkinv.traffic_bytes("walk", "none", 64) == 64 * 128
    assert [pkinv.parse(v) for v in ("cur", "nodiv32", "cur_chip32",
                                     "none_chip16")] == [
        ("walk", "cur", 64), ("walk", "nodiv", 32), ("chip", "cur", 32),
        ("chip", "none", 16)]
