"""kangaroo_torch's device watchdog vs the JAX package's, on the CPU.

A device->host read of the solve runs under a bound (device_timeout):
a read that outlasts it raises DeviceHangError, and the solve then
saves its table alone to the work file and returns, as the JAX solver
does (kangaroo_tpu/core/solver.py:1222-1245, :1254-1290).  A hang
cannot be staged on a card, so here the third read of each solve is
made to block (its callable waits on an event), in the JAX solver and
in the port alike: the port's table-only file must be byte-equal to the
JAX package's (the header's time field aside, a wall-clock reading) and
must resume with -i to the key.  Bytes: tolerance 0.
"""

import os
import subprocess
import sys
import threading
import time

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
from kangaroo_torch.io import backup  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
IN32 = os.path.join(ROOT, "fixtures", "in32.txt")
BOUND = 1.0  # seconds


def test_host_read_bounds_a_hung_read():
    """The counterpart of tests/test_solver.py:64: reads pass through,
    a hung one raises DeviceHangError within its bound, a read's own
    error reaches the caller, and a bound of 0 turns the watchdog off."""
    s = solver.KangarooSolver(parse_config_file(IN32), solver.SolverOptions(
        nb_kangaroo=16, device="cpu", quiet=True, device_timeout=0.2))
    assert s._host_read(lambda: 42) == 42
    release = threading.Event()
    t = time.time()
    with pytest.raises(solver.DeviceHangError):
        s._host_read(lambda: release.wait(30))
    assert time.time() - t < 5.0
    release.set()

    def fail():
        raise ValueError("device error")

    with pytest.raises(ValueError, match="device error"):
        s._host_read(fail)
    s.opts.device_timeout = 0.0
    assert s._host_read(lambda: 7) == 7


def _hang_third_read(s, release):
    """Make s's third _host_read block until `release`; returns a dict
    that receives the time the hung read began."""
    orig, calls, seen = s._host_read, [0], {}

    def read(fn):
        calls[0] += 1
        if calls[0] == 3:
            seen["t"] = time.time()
            return orig(lambda: release.wait(60))
        return orig(fn)

    s._host_read = read
    return seen


def test_hung_read_saves_table_only_file(tmp_path):
    """in32 at 512 lanes, dp 4, nb_run 16: the read of tick 3's DPs
    hangs while tick 4 runs, so both solvers stop with the DPs of ticks
    1-2 in the table and 4 ticks in the count, within the bound, and
    write the same table-only file; the CLI's -i resumes it to the
    key."""
    opts = dict(nb_kangaroo=512, dp_size=4, nb_run=16, seed=11, quiet=True,
                device_timeout=BOUND, save_period=3600)
    release = threading.Event()
    files = {}
    try:
        for name, s in (
            ("jax", jsolver.KangarooSolver(jparse(IN32), jsolver.SolverOptions(
                n_devices=1, backend="xla",
                work_file=str(tmp_path / "jax.work"), **opts))),
            ("torch", solver.KangarooSolver(
                parse_config_file(IN32), solver.SolverOptions(
                    device="cpu", work_file=str(tmp_path / "torch.work"),
                    **opts))),
        ):
            seen = _hang_third_read(s, release)
            assert s.solve(0, max_ticks=20) is None
            assert time.time() - seen["t"] < BOUND + 5.0
            assert s.stats.count == 4 * 512 * 16
            files[name] = open(tmp_path / f"{name}.work", "rb").read()
    finally:
        release.set()
    time_field = slice(148, 156)  # HEADW's f64 time

    def strip(b):
        return b[:time_field.start] + b[time_field.stop:]

    assert strip(files["torch"]) == strip(files["jax"])
    lw = backup.load_work(str(tmp_path / "torch.work"))
    assert lw.kangaroos is None and lw.hash_table.n_items() > 0
    assert lw.count == 4 * 512 * 16
    r = subprocess.run(
        [sys.executable, "-m", "kangaroo_torch.cli", "-device", "cpu", "-i",
         str(tmp_path / "torch.work"), "-nbrun", "16"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"Loaded: {lw.hash_table.n_items()} DPs, count {lw.count}" \
        in r.stdout
    assert "Priv: 0xB862A62E" in r.stdout
