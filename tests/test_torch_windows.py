"""kangaroo_torch's fused launch windows (-nwin) vs the JAX package's, on
the CPU.

A tick of kw windows walks kw launch windows and drains their DPs
together, each stepped by window * nb_run (kangaroo_tpu/core/solver.py:
473-502, :794).  For the same seed and options the port must fill its
table like the JAX solver with the same kw, kw windows in fewer ticks
must walk like as many one-window ticks (tests/test_solver.py:94, :110),
and with nb_run and windows_per_tick both auto the port must reach the
JAX solver's window, kw, table and stats (its auto rule, :390-411).
Integer data: tolerance 0.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

# the JAX solver's native table, loaded whatever the build race
pytestmark = pytest.mark.usefixtures("jax_native")

from kangaroo_tpu.core import curve as jcurve  # noqa: E402
from kangaroo_tpu.core import solver as jsolver  # noqa: E402
from kangaroo_tpu.core.config import ProblemConfig as JConfig  # noqa: E402
from kangaroo_torch.core import curve, solver  # noqa: E402
from kangaroo_torch.core.config import ProblemConfig  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
IN32 = os.path.join(ROOT, "fixtures", "in32.txt")
WIDTH = (1 << 32) - 1
START = 0x900000000
K = START + ((WIDTH // 3) | 1)


def _both(ticks, **kw):
    """The JAX solver and the port after `ticks` ticks of the options of
    tests/test_solver.py:_run_ticks (128 lanes, dp 4, seed 99) and kw."""
    opts = dict(nb_kangaroo=128, dp_size=4, seed=99, quiet=True) | kw
    js = jsolver.KangarooSolver(
        JConfig(START, START + WIDTH, [jcurve.mul(K)]),
        jsolver.SolverOptions(n_devices=1, backend="xla", **opts))
    js.solve(0, max_ticks=ticks)
    ts = solver.KangarooSolver(
        ProblemConfig(START, START + WIDTH, [curve.mul(K)]),
        solver.SolverOptions(device="cpu", **opts))
    ts.solve(0, max_ticks=ticks)
    return js, ts


def _assert_same(js, ts):
    assert ts.hash_table.export() == js.hash_table._export()
    assert ts.hash_table.n_items() > 0
    assert (ts.stats.dead, ts.stats.lost, ts.stats.count) == (
        js.stats.dead, js.stats.lost, js.stats.count)


@pytest.mark.parametrize("sym", [False, True], ids=["plain", "sym"])
def test_windows_per_tick_equals_jax(sym):
    """kw 4 x 2 ticks of 8 steps: the JAX solver's fused tick and the
    port's table, stats and kw agree."""
    js, ts = _both(2, nb_run=8, windows_per_tick=4, symmetry=sym)
    _assert_same(js, ts)
    assert ts.windows_per_tick == js._exec_cache[0][4] == 4
    assert ts.stats.ticks == 2 and ts.stats.count == 2 * 4 * 8 * 128


def _port_ticks(ticks, windows, sym):
    ts = solver.KangarooSolver(
        ProblemConfig(START, START + WIDTH, [curve.mul(K)]),
        solver.SolverOptions(nb_kangaroo=128, dp_size=4, nb_run=8, seed=99,
                             device="cpu", quiet=True, symmetry=sym,
                             windows_per_tick=windows))
    ts.solve(0, max_ticks=ticks)
    return ts


@pytest.mark.parametrize("sym", [False, True], ids=["plain", "sym"])
def test_windows_per_tick_parity(sym):
    """kw 1 x 8 ticks and kw 4 x 2 ticks: the same count and the same
    table (no dead lane in the window, so no reset lands elsewhere)."""
    s1, s4 = _port_ticks(8, 1, sym), _port_ticks(2, 4, sym)
    assert s1.stats.dead == 0 and s4.stats.dead == 0
    assert s1.stats.count == s4.stats.count
    t1 = list(s1.hash_table.iter_sorted())
    assert t1, "expected some DPs in the parity window"
    assert t1 == list(s4.hash_table.iter_sorted())


def test_auto_windows_equal_jax():
    """nb_run and windows_per_tick auto (the CLI's defaults): dp 4 at
    128 lanes halves the auto window from 64 to 8 steps for the slot
    budget, then fuses min(16, 4096 // 8) = 16 windows a tick, as the
    JAX solver does; a port that drained every window would walk
    differently."""
    js, ts = _both(2, nb_run=0, windows_per_tick=0)
    assert ts.opts.nb_run == js.opts.nb_run == 8
    assert ts.n_slots == js._exec_cache[0][5]
    assert ts.windows_per_tick == js._exec_cache[0][4] == 16
    _assert_same(js, ts)


@pytest.mark.parametrize("nb_run,slots,lanes,kw,want", [
    (1024, 6, 1 << 22, 0, 1),      # 1.9 GB of slots a window: no fusion
    (1024, 6, 1 << 18, 0, 4),      # 4096 // 1024
    (256, 6, 1 << 20, 0, 4),       # the 2 GB cap: int(2e9 / 4.78e8)
    (16, 8, 128, 0, 16),           # at most 16
    (64, 2, 1 << 22, 0, 3),        # the cap again: int(2e9 / 6.4e8)
    (512, 4, 1 << 22, 2, 2),       # an explicit -nwin is kept
])
def test_auto_rule(nb_run, slots, lanes, kw, want):
    """The auto rule at the card's sizes, by the JAX solver's formula:
    kw = max(1, min(16, 4096 // nb_run, 2e9 // slot bytes)), slot bytes =
    slots x 19 rows x 4 B x lanes; an explicit nb_run alone gives 1."""
    opts = SimpleNamespace(windows_per_tick=kw, nb_run=nb_run,
                           nb_kangaroo=lanes)
    assert solver.windows_per_tick(opts, slots, auto_window=True) == want
    if not kw:
        assert solver.windows_per_tick(opts, slots, auto_window=False) == 1


def test_cli_devices_and_nwin_on_cpu():
    """-devices and -nwin through the CLI: in32 over 2 CPU shards with 2
    windows a tick prints the key."""
    r = subprocess.run(
        [sys.executable, "-m", "kangaroo_torch.cli", "-device", "cpu",
         "-devices", "2", "-nwin", "2", "-nk", "512", "-d", "4", "-nbrun",
         "16", IN32], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Shards: 2 x 256 lanes on cpu, cpu" in r.stdout
    assert "Priv: 0xB862A62E" in r.stdout
