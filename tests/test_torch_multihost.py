"""kangaroo_torch's multi-process herd, on the CPU.

The counterpart of tests/test_multihost.py: `python -m
kangaroo_torch.parallel.multihost` starts 2 processes that form one
torch.distributed group over gloo (the rendezvous store on a port the OS
picks) and walk their lane shards of one herd with the production
sharded window; rank 0 holds the gathered walk against a one-process
walk (bit-equal, py mod p) and the all_reduce of the DP hits against the
one-process total.  Every wait is bounded (120 s), so a stuck rendezvous
fails the test instead of hanging its worker.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_two_processes_walk_bit_equal():
    r = subprocess.run(
        [sys.executable, "-m", "kangaroo_torch.parallel.multihost",
         "--device", "cpu", "--lanes", "256", "--steps", "16", "--dp", "4",
         "--timeout", "100"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["processes"] == 2 and res["lanes_per_process"] == 128
    assert res["bit_equal"] is True
    assert set(res["max_abs_err"].values()) == {0}
    assert res["reduced_hits"] == res["one_process_hits"] > 0
    # on the CPU each rank walks once through the plain version
    assert res["plain_calls"] == [1, 1] and res["launches"] == [0, 0]


def test_import_starts_nothing():
    """Importing the module starts no process and opens no store."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import threading, kangaroo_torch.parallel.multihost as m; "
         "import torch.distributed as d; "
         "print(threading.active_count(), d.is_initialized())"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["1", "False"]
