"""kangaroo_torch solver and CLI vs the JAX package, on the CPU.

For the same seed and options the port's solver must fill its hash table
exactly like the JAX solver (`backend="xla"`, one device) after a fixed
number of ticks: the same herd, the same walk, the same pipelined drain
(resets one tick late) and the same dead-lane redraws, in plain and in
symmetry mode.  The CLI solves the in32 fixture on the CPU, with and
without -sym, and runs -check on the CPU.
"""

import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

# the JAX solver's native table, loaded whatever the build race
pytestmark = pytest.mark.usefixtures("jax_native")

from kangaroo_tpu.core import solver as jsolver  # noqa: E402
from kangaroo_tpu.core.config import parse_config_file as jparse  # noqa: E402
from kangaroo_torch.core import solver  # noqa: E402
from kangaroo_torch.core.config import parse_config_file  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
IN32 = os.path.join(ROOT, "fixtures", "in32.txt")


@pytest.mark.parametrize("seed,ticks", [(11, 6), (13, 10)],
                         ids=["fixture-seed", "dead-lane-resets"])
def test_hash_table_equals_jax_solver(seed, ticks):
    """Options of test_fixtures.py::test_solve_in32; seed 13 meets dead
    kangaroos (same-herd collisions) before it solves at tick 10."""
    js = jsolver.KangarooSolver(jparse(IN32), jsolver.SolverOptions(
        nb_kangaroo=512, dp_size=4, nb_run=16, seed=seed, n_devices=1,
        backend="xla", quiet=True))
    jres = js.solve(0, max_ticks=ticks)
    ts = solver.KangarooSolver(parse_config_file(IN32), solver.SolverOptions(
        nb_kangaroo=512, dp_size=4, nb_run=16, seed=seed, device="cpu",
        quiet=True))
    tres = ts.solve(0, max_ticks=ticks)
    assert ts.hash_table.export() == js.hash_table._export()
    assert ts.hash_table.n_items() > 0
    assert (ts.stats.dead, ts.stats.lost, ts.stats.count) == (
        js.stats.dead, js.stats.lost, js.stats.count)
    assert (tres is None) == (jres is None)
    if tres is not None:
        assert tres.private_key == jres.private_key == 0xB862A62E
    if seed == 13:
        assert ts.stats.dead > 0


@pytest.mark.parametrize("seed,ticks", [(12, 5), (14, 10)],
                         ids=["dead-lane-resets", "solves"])
def test_sym_hash_table_equals_jax_solver(seed, ticks):
    """Symmetry mode: the recentred key, the signed distances and their
    record encoding, the class carried through the ticks and reset to 0
    on redrawn lanes.  Both seeds meet dead kangaroos; seed 14 solves at
    tick 7."""
    opts = dict(nb_kangaroo=512, dp_size=4, nb_run=16, seed=seed,
                quiet=True, symmetry=True)
    js = jsolver.KangarooSolver(jparse(IN32), jsolver.SolverOptions(
        n_devices=1, backend="xla", **opts))
    jres = js.solve(0, max_ticks=ticks)
    ts = solver.KangarooSolver(parse_config_file(IN32),
                               solver.SolverOptions(device="cpu", **opts))
    tres = ts.solve(0, max_ticks=ticks)
    assert ts.hash_table.export() == js.hash_table._export()
    assert ts.hash_table.n_items() > 0 and ts.stats.dead > 0
    assert (ts.stats.dead, ts.stats.lost, ts.stats.count) == (
        js.stats.dead, js.stats.lost, js.stats.count)
    assert (tres is None) == (jres is None) == (seed == 12)
    if tres is not None:
        assert (tres.private_key, tres.sign_info, tres.variant) == (
            jres.private_key, jres.sign_info, jres.variant)
        assert tres.private_key == 0xB862A62E


def test_work_model_matches_jax():
    cfg = jparse(IN32)
    js = jsolver.KangarooSolver(cfg, jsolver.SolverOptions(
        nb_kangaroo=1 << 12, n_devices=1, quiet=True))
    ts = solver.KangarooSolver(parse_config_file(IN32), solver.SolverOptions(
        nb_kangaroo=1 << 12, device="cpu", quiet=True))
    for nk in (256, 1 << 12, 1 << 22):
        assert ts.suggest_dp(nk) == js.suggest_dp(nk)
        assert ts.balanced_dp(nk, rate=3.5e6) == js.balanced_dp(nk, rate=3.5e6)
        for dp in (0.0, 5.0, 14.0):
            assert ts.compute_expected(dp, nk) == js.compute_expected(dp, nk)
    # symmetry: the expected work carries the 2^-0.5 gain
    jsym = jsolver.KangarooSolver(cfg, jsolver.SolverOptions(
        nb_kangaroo=1 << 12, n_devices=1, quiet=True, symmetry=True))
    tsym = solver.KangarooSolver(parse_config_file(IN32),
                                 solver.SolverOptions(
                                     nb_kangaroo=1 << 12, device="cpu",
                                     quiet=True, symmetry=True))
    for nk in (256, 1 << 22):
        assert tsym.suggest_dp(nk) == jsym.suggest_dp(nk)
        assert tsym.balanced_dp(nk, rate=3.5e6) == \
            jsym.balanced_dp(nk, rate=3.5e6)
        for dp in (0.0, 5.0, 14.0):
            got = tsym.compute_expected(dp, nk)
            assert got == jsym.compute_expected(dp, nk)
            ratio = got[0] / ts.compute_expected(dp, nk)[0]
            assert abs(ratio - 2 ** -0.5) < 1e-12
    for nb_run, dp, n in ((16, 4, 512), (1024, 14, 1 << 22), (64, 2, 4096)):
        assert solver.slots_for_window(nb_run, dp, n) == \
            jsolver.slots_for_window(nb_run, dp, n)
        assert solver.poisson_tail(nb_run / 2 ** dp, 3) == \
            jsolver.poisson_tail(nb_run / 2 ** dp, 3)


@pytest.mark.parametrize("symmetry", [False, True], ids=["plain", "sym"])
def test_encode_records_equals_convert(symmetry):
    """hashtable.encode_records of random (m, 20) blocks in shuffled
    walk order, tame and wild lanes, against the table's own per-record
    conversion: hashtable.convert of x, the mod-n distance of
    packing.true_dist_limbs and the lane's parity; the lanes come back
    in walk order (step, then lane)."""
    import numpy as np

    from kangaroo_torch.core import hashtable
    from kangaroo_torch.utils import packing

    rs = np.random.RandomState(5 + symmetry)
    wd2 = ((1 << 100) - 1) >> 1
    m = 600
    cells = rs.choice(64 * 1024, m, replace=False)  # distinct (step, lane)
    blk = np.zeros((m, 20), dtype=np.int32)
    blk[:, 0:10] = rs.randint(0, 1 << 16, (m, 10))
    if symmetry:  # signed 128-bit distances, |d| < 2^100
        ds = [int(v) << 40 | int(u) for v, u in zip(
            rs.randint(-(1 << 59), 1 << 59, m), rs.randint(0, 1 << 40, m))]
        ds[:3] = [0, -1, 1]
    else:  # device distances in [0, 2 * wd2]
        ds = [int(v) << 50 | int(u) for v, u in zip(
            rs.randint(0, 1 << 50, m), rs.randint(0, 1 << 50, m))]
        ds[:4] = [0, wd2, wd2 - 1, wd2 + 1]
    du = [d & ((1 << 128) - 1) for d in ds]
    blk[:, 10:18] = [[(d >> (16 * k)) & 0xFFFF for k in range(8)] for d in du]
    blk[:, 18] = cells // 1024
    blk[:, 19] = cells % 1024
    blk[:4, 19] = [2, 3, 5, 7]  # tame and wild lanes at the edge cases
    blk[:4, 18] = 64

    rec, lanes = hashtable.encode_records(blk, wd2, symmetry)

    order = np.lexsort((blk[:, 19], blk[:, 18]))
    np.testing.assert_array_equal(lanes, blk[order, 19])
    types = blk[:, 19] & 1
    dm = packing.true_dist_limbs(blk[:, 10:18].T, types, wd2, symmetry)
    want = []
    for r in order:
        x = sum(int(blk[r, k]) << (16 * k) for k in range(10))
        d = sum(int(dm[k, r]) << (16 * k) for k in range(16))
        h, x128, d128 = hashtable.convert(x, d, int(types[r]))
        want.append(h.to_bytes(4, "little") + x128.to_bytes(16, "little")
                    + d128.to_bytes(16, "little"))
    assert rec.dtype == np.uint8 and rec.shape == (m, 36)
    assert rec.tobytes() == b"".join(want)


def test_device_rules():
    cfg = parse_config_file(IN32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solver.KangarooSolver(cfg, solver.SolverOptions(device="cuda"))
    ts = solver.KangarooSolver(cfg, solver.SolverOptions(
        nb_kangaroo=513, device="cpu", quiet=True))
    assert ts.opts.nb_kangaroo == 514          # even: lane parity = type
    with pytest.raises(ValueError):
        solver.resolve_device("meta")


def _cli(*args, timeout=600):
    # few threads: the suite runs in parallel worker processes
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "kangaroo_torch.cli", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_solves_in32_on_cpu():
    r = _cli("-device", "cpu", IN32)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Priv: 0xB862A62E" in r.stdout


def test_cli_solves_in32_sym_on_cpu():
    r = _cli("-device", "cpu", "-sym", IN32)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Symmetry: on" in r.stdout
    assert "Priv: 0xB862A62E" in r.stdout
    # the result line carries the collision's variant and N/S sign
    assert re.search(r"Key# 0 \[[0-3][NS]\]Pub:", r.stdout), r.stdout


def test_cli_rejects_flags_not_yet_ported():
    """Every flag of the JAX CLI is ported (-nwin and -devices parse and
    show in the usage); the JAX backend and platform flags are refused
    with a message that names -device."""
    from kangaroo_torch import cli

    assert cli.NOT_YET_PORTED == ()
    r = _cli("-nwin", "2", "-devices", "2", "-h", timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "not yet ported" not in r.stdout
    assert " -nwin k:" in r.stdout and " -devices n:" in r.stdout
    # the JAX backend and platform flags: -device takes their place
    for flag in ("-backend", "-platform"):
        r = _cli(flag, "x", IN32, timeout=120)
        assert r.returncode != 0
        assert "use -device cuda|cpu" in r.stdout
    r = _cli("-v", timeout=120)
    assert r.returncode == 0 and "torch" in r.stdout


def test_cli_check_on_cpu():
    """-check on the CPU: the plain ops, k*G, the walk, the volume oracle
    (plain ops and field.cuh's g++ build) and the walk body's lockstep."""
    r = _cli("-device", "cpu", "-check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Check: ALL OK" in r.stdout
    assert "Check: kernel lockstep [cpu, sym=True] OK" in r.stdout
