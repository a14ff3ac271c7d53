"""The CUDA walk kernel, the herd kernel and the probe kernels against
their plain versions, on the card, and the work files' save, resume and
-wcheck there.

Needs a CUDA card (the kernel has no CPU mode) and skips without one.
Imports only the port, so it runs on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

chip_smoke.py runs the same comparison at the main path's shape (2^22
lanes, 256 blocks), the plain walk on 64 lanes of every block, for the
plain and the symmetry kernel, and the probe kernels at small shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kangaroo_torch.core import curve, herd  # noqa: E402
from kangaroo_torch.core.jumptable import create_jump_table  # noqa: E402
from kangaroo_torch.ops import (  # noqa: E402
    field, jump_cuda, jump_ref, probe_cuda, probe_ref)
from kangaroo_torch.utils.rng import MT19937  # noqa: E402

NAMES = ("px", "py", "d", "count", "dpx", "dpd", "step")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dp_size,slots", [(4, 2), (12, 3)],
                         ids=["overflow", "sparse"])
def test_kernel_matches_plain_on_card(card, dp_size, slots):
    rp = 64
    n = 2 * jump_cuda.LANE_QUANTUM
    state = herd.create_herd(n, rp, ((1 << rp) - 1) >> 1,
                             curve.mul(0xDEADBEEF12345), 0, MT19937(3),
                             device=card)
    tabs = [torch.from_numpy(a.astype("int32")).to(card)
            for a in create_jump_table(rp).as_arrays()]
    masks = jump_ref.dp_limb_masks(dp_size, card)
    launches = jump_cuda.LAUNCHES
    k = jump_cuda.jump_steps_with_dp(*[t.clone() for t in state], *tabs,
                                     masks, nb_run=32, slots=slots)
    p = jump_ref.jump_steps_with_dp(*[t.clone() for t in state], *tabs,
                                    masks, nb_run=32, slots=slots)
    torch.cuda.synchronize()
    assert jump_cuda.LAUNCHES == launches + 1
    for name, a, b in zip(NAMES, k, p):
        if name == "py":
            a, b = field.canonicalize(a), field.canonicalize(b)
        assert torch.equal(a, b), name
    assert int(k[3].sum()) > 0
    assert bool((k[3] > slots).any()) == (dp_size == 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dp_size,slots", [(4, 2), (12, 3)],
                         ids=["overflow", "sparse"])
def test_sym_kernel_matches_plain_on_card(card, dp_size, slots):
    """Symmetry kernel vs the plain symmetry walk, from a class input
    that holds both classes: every output bit-equal (py is canonical)."""
    rp = 64
    n = 2 * jump_cuda.LANE_QUANTUM
    state = herd.create_herd(n, rp, ((1 << rp) - 1) >> 1,
                             curve.mul(0xDEADBEEF12345), 1, MT19937(5),
                             device=card, symmetry=True)
    tabs = [torch.from_numpy(a.astype("int32")).to(card)
            for a in create_jump_table(rp, symmetry=True).as_arrays()]
    masks = jump_ref.dp_limb_masks(dp_size, card)
    gen = torch.Generator().manual_seed(5)
    sc = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
    sc = sc.to(card)
    launches = (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES)
    k = jump_cuda.jump_steps_with_dp(*[t.clone() for t in state], *tabs,
                                     masks, nb_run=32, slots=slots,
                                     symmetry=True, symclass=sc.clone())
    p = jump_ref.jump_steps_with_dp(*[t.clone() for t in state], *tabs,
                                    masks, nb_run=32, slots=slots,
                                    symmetry=True, symclass=sc.clone())
    torch.cuda.synchronize()
    assert (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES) == (
        launches[0], launches[1] + 1)
    for name, a, b in zip(NAMES + ("symclass",), k, p):
        assert torch.equal(a, b), name
    assert int(k[3].sum()) > 0
    assert bool((k[3] > slots).any()) == (dp_size == 4)
    assert 0 < int((k[7] != sc).sum()) < n


@pytest.mark.cuda
@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_walk_kernel_fits_one_wave_without_spill(card, symmetry):
    """Each walk kernel: at most 128 registers and no local memory but
    its prefix products (G x 32 B), MIN_BLOCKS resident blocks per SM,
    and a 2^22-lane grid in one wave."""
    occ = jump_cuda.occupancy(1 << 22, symmetry)
    assert occ["regs"] <= 65536 // (jump_cuda.THREADS
                                    * jump_cuda.MIN_BLOCKS)
    assert occ["local_bytes"] <= jump_cuda.GROUP * 32
    assert occ["blocks_per_sm"] >= jump_cuda.MIN_BLOCKS
    assert occ["one_wave"]


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    n = jump_cuda.LANE_QUANTUM
    z16 = torch.zeros((16, n), dtype=torch.int32, device=card)
    z8 = torch.zeros((8, n), dtype=torch.int32, device=card)
    t16 = torch.zeros((16, 32), dtype=torch.int32, device=card)
    t8 = torch.zeros((8, 32), dtype=torch.int32, device=card)
    m = jump_ref.dp_limb_masks(8, card)
    with pytest.raises(ValueError, match="lane quantum"):
        jump_cuda.jump_steps_with_dp(z16[:, :64].contiguous(),
                                     z16[:, :64].contiguous(),
                                     z8[:, :64].contiguous(), t16, t16, t8, m)
    with pytest.raises(ValueError, match="nb_run"):
        jump_cuda.jump_steps_with_dp(z16, z16, z8, t16, t16, t8, m,
                                     nb_run=1 << 16)
    with pytest.raises(ValueError, match="int32"):
        jump_cuda.jump_steps_with_dp(z16.long(), z16, z8, t16, t16, t8, m)
    with pytest.raises(ValueError, match="symclass"):
        jump_cuda.jump_steps_with_dp(z16, z16, z8, t16, t16, t8, m,
                                     symmetry=True, symclass=z8[0, :64])


def _limbs(rs, rows, n, dev):
    return torch.from_numpy(
        rs.randint(0, 1 << 16, (rows, n)).astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("op", probe_ref.FIELD_OPS)
def test_field_chain_matches_plain_on_card(card, op):
    """P1 on 2 blocks x 3 rounds (fe_inv 1 round): canonical equal."""
    rs = np.random.RandomState(1)
    n = 2 * (jump_cuda.LANE_QUANTUM if op == "step" else probe_cuda.THREADS)
    rounds = 1 if op == "inv" else 3
    a, b = _limbs(rs, 16, n, card), _limbs(rs, 16, n, card)
    jx, jy = _limbs(rs, 16, 32, card), _limbs(rs, 16, 32, card)
    key = probe_cuda.kernel_key("field_chain", op)
    launches = probe_cuda.LAUNCHES[key]
    got = probe_cuda.field_chain(op, a.clone(), b, rounds, jx, jy)
    want = probe_ref.field_chain(op, a, b, rounds, jx, jy)
    torch.cuda.synchronize()
    assert probe_cuda.LAUNCHES[key] == launches + 1
    assert torch.equal(field.canonicalize(got), field.canonicalize(want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("words", "band", "edges", "mixed"))
@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_mul_sqr_every_carry_pattern_on_card(card, op, case):
    """fe_mul and fe_sqr on the card, one P1 round a lane, against Python
    ints on tests/carry_cases.py's operands (the host build's sets):
    below 2^256 and congruent to the product mod p."""
    from tests import carry_cases as cc

    if op == "mul":
        a, b = cc.mul_pairs(case)
    else:
        a = b = cc.sqr_values(case)
    pad = [0] * (-len(a) % probe_cuda.THREADS)
    x, y = (torch.from_numpy(cc.to_limbs(cc.to_words(v + pad).T)).to(card)
            for v in (a, b))
    key = probe_cuda.kernel_key("field_chain", op)
    launches = probe_cuda.LAUNCHES[key]
    got = probe_cuda.field_chain(op, x, y, 1)
    assert probe_cuda.LAUNCHES[key] == launches + 1
    r = cc.from_limbs(got.cpu().numpy())[:len(a)]
    assert cc.wrong(cc.to_ints(r), [u * v for u, v in zip(a, b)]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("ones_zeros", "mixed"))
def test_reduce512_every_carry_pattern_on_card(card, case):
    """fe_reduce512 on the card (probe_cuda.reduce512) against Python
    ints on the host build's 512-bit inputs: below 2^256, congruent mod
    p."""
    from tests import carry_cases as cc

    t = cc.reduce_inputs(case)
    w = cc.to_words(t, 16)
    lo, hi = (torch.from_numpy(cc.to_limbs(np.ascontiguousarray(h.T)))
              .to(card) for h in (w[:, :8], w[:, 8:]))
    launches = probe_cuda.LAUNCHES["reduce512"]
    got = probe_cuda.reduce512(lo, hi)
    assert probe_cuda.LAUNCHES["reduce512"] == launches + 1
    assert cc.wrong(cc.to_ints(cc.from_limbs(got.cpu().numpy())), t) == 0


@pytest.mark.cuda
def test_carry_chains_keep_their_carries_on_card(card):
    """In the SASS of both walk kernels, the herd kernel, P1's multiply
    and squaring and the reduction's entry, no instruction overwrites an
    add chain's carry before it is read (utils/sass.lost_carries)."""
    from kangaroo_torch.ops import herd_cuda
    from kangaroo_torch.utils import sass

    funcs = {}
    for lib in (jump_cuda.build(), herd_cuda.build(), probe_cuda.build()):
        funcs.update(sass.sass_functions(lib))
    tags = ("kt_jump_kernelILb0", "kt_jump_kernelILb1", "kt_herd_kernel",
            "kt_field_chainILi0E", "kt_field_chainILi1E",
            "kt_reduce512_kernel")
    lost = {tag: sass.lost_carries(lines) for tag in tags
            for name, lines in funcs.items() if tag in name}
    assert lost == {tag: [] for tag in tags}


@pytest.mark.cuda
@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_search_herd_window_matches_plain_on_card(card, symmetry):
    """A puzzle #85 search herd (2^22 lanes of an 84-bit range, made by
    the herd kernel) walked one whole window of the search (1024 steps,
    dp 16, 4 slots) by the walk kernel, against the plain walk on the
    four corner lanes of every block (chip_smoke.py's compare subset):
    every output bit-equal (py canonical)."""
    from kangaroo_torch.ops import herd_cuda

    n, rp = 1 << 22, 84
    launches = herd_cuda.LAUNCHES
    state = herd.create_herd(n, rp, ((1 << rp) - 1) >> 1,
                             curve.mul(0xA1F5302F24DC55964EECE), 0,
                             MT19937(85), device=card, symmetry=symmetry)
    assert herd_cuda.LAUNCHES == launches + 1
    if symmetry:
        state = state + (torch.zeros(n, dtype=torch.int32, device=card),)
    tabs = [torch.from_numpy(a.astype("int32")).to(card)
            for a in create_jump_table(rp, symmetry).as_arrays()]
    masks = jump_ref.dp_limb_masks(16, card)
    q, t = jump_cuda.LANE_QUANTUM, jump_cuda.THREADS
    idx = torch.tensor([b * q + c for b in range(n // q)
                        for c in (0, t - 1, q - t, q - 1)], device=card)
    sub = [x[..., idx].contiguous() for x in state]
    kw = ({"symmetry": True, "symclass": state[3]} if symmetry else {})
    k = jump_cuda.jump_steps_with_dp(*state[:3], *tabs, masks, nb_run=1024,
                                     slots=4, **kw)
    k = [x[..., idx] for x in k]
    kw = ({"symmetry": True, "symclass": sub[3]} if symmetry else {})
    p = jump_ref.jump_steps_with_dp(*sub[:3], *tabs, masks, nb_run=1024,
                                    slots=4, **kw)
    for name, a, b in zip(NAMES + ("symclass",), k, p):
        if name == "py":
            a, b = field.canonicalize(a), field.canonicalize(b)
        assert torch.equal(a, b), name
    assert int(p[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("op,ilp,smem", [
    (op, ilp, 0) for op in probe_ref.RAW_OPS
    for ilp in probe_cuda.RAW_ILPS[op]] + [("layout", 1, 100 * 1024)])
def test_raw_chain_matches_plain_on_card(card, op, ilp, smem):
    """P2 on 2 blocks x 64 iterations: integers bit-equal, f32 within
    rtol 1e-5 (the fused multiply-add's plain version rounds twice)."""
    rs = np.random.RandomState(2)
    n = 2 * probe_cuda.THREADS * ilp
    if op in probe_ref.F32_OPS:
        x = torch.from_numpy(rs.uniform(1, 2, n).astype(np.float32))
    else:
        x = torch.from_numpy(rs.randint(1, 1 << 16, n).astype(np.int32))
    x = x.to(card)
    got = probe_cuda.raw_chain(op, x.clone(), 64, ilp, smem)
    want = probe_ref.raw_chain(op, x, 64)
    torch.cuda.synchronize()
    if op in probe_ref.F32_OPS:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,group", [
    pytest.param(v, g, id=v if g == jump_cuda.GROUP else f"{v}-G{g}")
    for v in probe_ref.DELTA_VARIANTS for g in probe_cuda.DELTA_GROUPS[v]])
def test_delta_walk_matches_plain_on_card(card, variant, group):
    """P3 at its G on 2 blocks x 4 steps, dp 3 and 2 slots (lanes
    overflow)."""
    n = 2 * jump_cuda.THREADS * group
    rs = np.random.RandomState(3)
    state = [_limbs(rs, r, n, card) for r in (16, 16, 8)]
    tabs = [torch.from_numpy(a.astype("int32")).to(card)
            for a in create_jump_table(64).as_arrays()]
    masks = jump_ref.dp_limb_masks(3, card)
    key = probe_cuda.kernel_key("delta", variant, group)
    launches = probe_cuda.LAUNCHES[key]
    got = probe_cuda.delta_walk(variant, *[t.clone() for t in state], *tabs,
                                masks, 4, 2, group)
    want = probe_ref.delta_walk(variant, *state, *tabs, masks, 4, 2)
    torch.cuda.synchronize()
    assert probe_cuda.LAUNCHES[key] == launches + 1
    for name, a, b in zip(NAMES, got, want):
        if name == "py":
            a, b = field.canonicalize(a), field.canonicalize(b)
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("variant,group", [
    (v, g) for v in probe_ref.INV_VARIANTS for g in probe_cuda.INV_GROUPS[v]])
def test_inv_chain_matches_plain_on_card(card, variant, group):
    """P4 on 2 blocks of its G x 2 iterations: bit-equal (canonical)."""
    rs = np.random.RandomState(4)
    x = _limbs(rs, 16, 2 * probe_cuda.THREADS * group, card) | 1
    got = probe_cuda.inv_chain(variant, x.clone(), 2, group)
    want = probe_ref.inv_chain(variant, x, 2, group)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,group", [
    (v, g) for v in probe_ref.INV_VARIANTS for g in probe_cuda.CHIP_GROUPS])
def test_inv_chip_matches_plain_on_card(card, variant, group):
    """P4's on-chip form on 8192 lanes (2 to 8 blocks) x 2 iterations:
    bit-equal to the plain chain over its lane sets; its cur also to the
    walk layout's cur (G 64), its nodiv at G 32 to the walk layout's
    nodiv32 (the same lane sets); no local memory; one launch counted."""
    rs = np.random.RandomState(5)
    n = 8192
    x = _limbs(rs, 16, n, card) | 1
    key = probe_cuda.kernel_key("inv_chip", variant, group)
    launches = probe_cuda.LAUNCHES[key]
    got = probe_cuda.inv_chip(variant, x.clone(), 2, group)
    want = probe_ref.inv_chain(variant, x, 2,
                               sets=probe_ref.lane_sets(n, group))
    torch.cuda.synchronize()
    assert probe_cuda.LAUNCHES[key] == launches + 1
    assert torch.equal(got, want)
    walk_g = {"cur": 64, "nodiv": 32 if group == 32 else None,
              "none": 64}[variant]
    if walk_g:
        walk = probe_cuda.inv_chain(variant, x.clone(), 2, walk_g)
        assert torch.equal(got, walk)
    assert probe_cuda.attrs("inv_chip", variant, group)["local_bytes"] == 0


@pytest.mark.cuda
def test_probe_wrappers_reject_what_the_kernels_do_not_take(card):
    z = torch.zeros((16, 200), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple"):
        probe_cuda.field_chain("mul", z, z, 1)
    with pytest.raises(ValueError, match="table"):
        probe_cuda.field_chain("gather", z[:, :128].contiguous(),
                               z[:, :128].contiguous(), 1)
    with pytest.raises(ValueError, match="ILP"):
        probe_cuda.raw_chain("u32_add", z[0].contiguous(), 1, ilp=3)
    with pytest.raises(ValueError, match="G = 100"):
        probe_cuda.inv_chain("cur", z, 1, group=100)
    with pytest.raises(ValueError, match="G = 64"):
        probe_cuda.inv_chip("cur", z, 1, group=64)


@pytest.mark.cuda
@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_checkpoint_resume_and_wcheck_on_card(card, tmp_path, symmetry):
    """Work files on the card at one lane quantum: a solve saves its
    herd every tick, stops; the file's herd is the snapshot the save
    took, -wcheck re-derives every DP with 0 wrong, and the resumed
    solve reaches the key through its walk kernel only, its count
    continuing from the file's."""
    from kangaroo_torch.core.check import check_work_file
    from kangaroo_torch.core.config import ProblemConfig
    from kangaroo_torch.core.solver import KangarooSolver, SolverOptions
    from kangaroo_torch.io import backup
    from kangaroo_torch.utils.packing import canon_mod_p

    # a 44-bit range: about 16 ticks of 2^19 jumps to the key
    start = 0x7A000000000000
    key = start + 0x9C5A9E21B37
    cfg = ProblemConfig(start, start + (1 << 44) - 1, [curve.mul(key)])
    wf = str(tmp_path / "w.work")
    n = jump_cuda.LANE_QUANTUM
    run = dict(nb_kangaroo=n, dp_size=6, nb_run=64, device="cuda",
               quiet=True, symmetry=symmetry)
    s = KangarooSolver(cfg, SolverOptions(
        seed=7, work_file=wf, save_period=0, save_kangaroo=True, **run))
    assert s.solve(0, max_ticks=3) is None
    lw = backup.load_work(wf)
    assert lw.symmetry == symmetry and lw.nb_kangaroo == n
    snap = [t.numpy().astype(np.uint32) for t in s._snap]
    np.testing.assert_array_equal(lw.kangaroos[0], snap[0])
    np.testing.assert_array_equal(lw.kangaroos[1], canon_mod_p(snap[1]))
    np.testing.assert_array_equal(lw.kangaroos[2], snap[2])
    rep = check_work_file(wf, device="cuda")
    assert rep.n_items == lw.hash_table.n_items() > 0 and rep.n_wrong == 0
    s2 = KangarooSolver.from_work(lw, SolverOptions(seed=8, **run))
    launches = (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES, jump_ref.CALLS)
    res = s2.solve(0)
    assert res is not None and res.private_key == key
    assert s2.stats.count == lw.count + s2.stats.ticks * n * 64
    plain, sym, calls = (a - b for a, b in zip(
        (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES, jump_ref.CALLS),
        launches))
    assert calls == 0 and (sym if symmetry else plain) == s2.stats.ticks
    assert (plain if symmetry else sym) == 0


def _serve(srv):
    """Start a DPServer on an ephemeral port in a thread."""
    import threading
    import time

    srv.process_period = 0.1
    t = threading.Thread(target=srv.run, daemon=True,
                         kwargs={"max_seconds": 120, "quiet": True})
    t.start()
    deadline = time.time() + 10
    while srv.port == 0 and time.time() < deadline:
        time.sleep(0.02)
    assert srv.port != 0
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_loopback_solve_on_card(card, symmetry):
    """A client at 2^16 lanes walks on the card through its walk kernel
    only and streams its DPs over loopback; the server finds the key and
    the client hears the end."""
    from kangaroo_torch.core.config import ProblemConfig
    from kangaroo_torch.core.solver import SolverOptions
    from kangaroo_torch.net.client import run_client
    from kangaroo_torch.net.server import DPServer

    start = 0x7A000000000000
    key = start + 0x9C5A9E21B37
    cfg = ProblemConfig(start, start + (1 << 44) - 1, [curve.mul(key)])
    srv = DPServer(cfg, 6, port=0, symmetry=symmetry, device="cuda")
    t = _serve(srv)
    launches = (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES, jump_ref.CALLS)
    rep = run_client("127.0.0.1", srv.port, SolverOptions(
        nb_kangaroo=1 << 16, nb_run=64, seed=7, device="cuda",
        symmetry=symmetry, quiet=True), timeout=10.0, quiet=True,
        send_period=0.2, reconnect_timeout=10.0)
    t.join(timeout=30)
    assert not t.is_alive()
    assert srv.result is not None and srv.result.private_key == key
    assert rep.ended and rep.dps_sent > 0
    plain, sym, calls = (a - b for a, b in zip(
        (jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES, jump_ref.CALLS),
        launches))
    assert calls == 0 and (sym if symmetry else plain) == rep.solver.stats.ticks
    assert (plain if symmetry else sym) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_server_validation_on_card(card, symmetry):
    """The server re-derives real wire records on the card: the forged
    ones (x ^ 1) are rejected, exactly, and the rest kept."""
    from kangaroo_torch.core.config import ProblemConfig
    from kangaroo_torch.core.solver import KangarooSolver, SolverOptions
    from kangaroo_torch.net.server import DPServer

    start = 0x7A000000000000
    cfg = ProblemConfig(start, start + (1 << 60) - 1,
                        [curve.mul(start + 0x9C5A9E21B3712)])
    s = KangarooSolver(cfg, SolverOptions(
        nb_kangaroo=1 << 16, nb_run=64, dp_size=8, seed=7, device="cuda",
        symmetry=symmetry, quiet=True))
    raw = []
    s.solve(0, max_ticks=3, dp_sink=lambda r, m: raw.append(r) or False)
    arr = np.frombuffer(b"".join(raw), np.uint8).reshape(-1, 40).copy()
    bad = np.zeros(len(arr), dtype=bool)
    bad[::100] = True
    arr[bad, 8] ^= 1
    srv = DPServer(cfg, 8, port=0, validate_points=True, symmetry=symmetry,
                   device="cuda")
    srv.recv_dp = [arr.tobytes()]
    srv._process_once()
    assert len(arr) > 1000 and srv.rejected == int(bad.sum())
    assert srv.hash_table.n_items() + srv.dead == len(arr) - int(bad.sum())


def _walk_inputs(card, n, symmetry=False):
    rp = 64
    state = herd.create_herd(n, rp, ((1 << rp) - 1) >> 1,
                             curve.mul(0xDEADBEEF12345), 0, MT19937(7),
                             device=card, symmetry=symmetry)
    tabs = [torch.from_numpy(a.astype("int32")).to(card)
            for a in create_jump_table(rp, symmetry).as_arrays()]
    return state, tabs + [jump_ref.dp_limb_masks(8, card)]


@pytest.mark.cuda
def test_launch_on_a_card_that_is_not_current(card):
    """A herd on cuda:0 launched while cuda:1 is current runs on cuda:0
    (the wrapper makes px's device current) and equals the launch made
    with cuda:0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    state, tabs = _walk_inputs(card, jump_cuda.LANE_QUANTUM)
    want = jump_cuda.jump_steps_with_dp(*[t.clone() for t in state], *tabs,
                                        nb_run=16, slots=2)
    with torch.cuda.device(1):
        got = jump_cuda.jump_steps_with_dp(*[t.clone() for t in state],
                                           *tabs, nb_run=16, slots=2)
    torch.cuda.synchronize(card)
    for name, a, b in zip(NAMES, got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_two_shards_on_one_card_equal_one_launch(card, symmetry):
    """Two lane shards on one card, each on its own stream (the sharded
    window of parallel/sharding.py), bit-equal to one launch over the
    whole herd, symclass included."""
    from kangaroo_torch.parallel import sharding

    n = 2 * jump_cuda.LANE_QUANTUM
    state, tabs = _walk_inputs(card, n, symmetry)
    sc = torch.zeros(n, dtype=torch.int32, device=card)
    want = jump_cuda.jump_steps_with_dp(
        *[t.clone() for t in state], *tabs, nb_run=32, slots=2,
        symmetry=symmetry, symclass=sc.clone() if symmetry else None)
    shards = sharding.make_shards([card, card], n, jump_cuda.LANE_QUANTUM)
    assert len(shards) == 2 and shards[0].stream != shards[1].stream
    herds = [list(h) + [h[3] if symmetry else None]
             for h in sharding.shard_herd(shards, *state, sc)]
    tick = sharding.make_sharded_jump_steps(shards, 32, 2, symmetry)
    launches = jump_cuda.SYM_LAUNCHES if symmetry else jump_cuda.LAUNCHES
    outs = tick(herds, sharding.replicate(shards, *tabs))
    sharding.synchronize(shards)
    now = jump_cuda.SYM_LAUNCHES if symmetry else jump_cuda.LAUNCHES
    assert now == launches + 2
    got = [torch.cat([o[k] for o in outs], dim=-1) for k in range(len(want))]
    for name, a, b in zip(NAMES + ("symclass",), got, want):
        assert torch.equal(a, b), name
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 8192, 150001])
@pytest.mark.parametrize("windows", [1, 5, 11, 16])
def test_herd_kernel_matches_plain_on_card(card, windows, n):
    """kt_herd_kernel against herd_cuda's plain version on the card, on
    the edge lanes of tests/test_torch_herd_kernel.py (|d| = 0, zero low,
    middle and top windows, neg, wild and tame lanes) and random ones;
    keyToSearch at infinity on the 63-lane herds.  The lane counts take
    G = 1 (1, 63, 8192 lanes) and G = 8 (150001: a ragged tail)."""
    from kangaroo_torch.ops import herd_cuda
    from tests.test_torch_herd_kernel import KEY, herd_lanes

    mag, neg, wild = herd_lanes(n, windows, seed=n + windows,
                                   device=card)
    key = None if n == 63 else KEY
    launches = herd_cuda.LAUNCHES
    got = herd_cuda.positions(mag, neg, wild, key, windows)
    assert herd_cuda.LAUNCHES == launches + 1
    want = herd_cuda.positions_plain(mag, neg, wild, key, windows)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_herd_kernel_matches_plain_on_a_search_herd(card):
    """A search's herd less 3 lanes at 11 windows: G = 64, 512 blocks,
    the last one ragged."""
    from kangaroo_torch.ops import herd_cuda
    from tests.test_torch_herd_kernel import KEY, herd_lanes

    n = (1 << 22) - 3
    mag, neg, wild = herd_lanes(n, 11, seed=22, device=card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert herd_cuda.group_for(n, sms) == 64
    got = herd_cuda.positions(mag, neg, wild, KEY, 11)
    want = herd_cuda.positions_plain(mag, neg, wild, KEY, 11)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_herd_wrapper_rejects_what_the_kernel_does_not_take(card):
    from kangaroo_torch.ops import herd_cuda
    from tests.test_torch_herd_kernel import KEY, herd_lanes

    mag, neg, wild = herd_lanes(64, 5, seed=3, device=card)
    launches = herd_cuda.LAUNCHES
    for args, match in (
            ((mag, neg.cpu(), wild), "on cuda"),
            ((mag.long(), neg, wild), "int32"),
            ((mag, neg, wild.int()), "bool"),
            ((mag[:8].contiguous(), neg, wild), "contiguous"),
            ((mag.t().contiguous().t(), neg, wild), "contiguous")):
        with pytest.raises(ValueError, match=match):
            herd_cuda.positions(*args, KEY, 5)
    with pytest.raises(ValueError, match="windows"):
        herd_cuda.positions(mag, neg, wild, KEY, 33)
    assert herd_cuda.LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_herd_on_card_equals_cpu_herd(card, symmetry):
    """create_herd on the card, and create_herd_shards in 2 shards of one
    card (each on its own stream), equal create_herd on the CPU lane for
    lane: the kernel on the main path, the plain version on the CPU."""
    from kangaroo_torch.ops import herd_cuda
    from kangaroo_torch.parallel import sharding

    n, rp = 3 * 8192 + 2, 40
    args = (n, rp, (1 << 39) - 5, curve.mul(0xDEADBEEF7), 1)
    want = herd.create_herd(*args, MT19937(17), device="cpu",
                            symmetry=symmetry)
    launches = herd_cuda.LAUNCHES
    one = herd.create_herd(*args, MT19937(17), device=card,
                           symmetry=symmetry)
    shards = sharding.make_shards([card, card], n)
    assert len(shards) == 2 and shards[0].stream != shards[1].stream
    parts = herd.create_herd_shards(*args[:4], shards, args[4],
                                    MT19937(17), symmetry=symmetry)
    sharding.synchronize(shards)
    torch.cuda.synchronize()
    assert herd_cuda.LAUNCHES == launches + 3
    two = [torch.cat([p[k] for p in parts], dim=-1) for k in range(3)]
    for got in (one, two):
        for name, a, b in zip(("px", "py", "d"), got, want):
            assert torch.equal(a.cpu(), b), name
