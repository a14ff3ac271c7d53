"""What portbench.run loads: no module whose top-level name is jax,
jaxlib, flax or kangaroo_tpu; and the reference loads nothing of the
port (kangaroo_torch).  Each in a fresh interpreter."""

import os
import subprocess
import sys

from pb_tiny import REPO

RUN_PROBE = r"""
import sys
import portbench.run
from portbench import bench, compare, faults, harness, trace
from portbench.reference import kangaroo, secp256k1
from portbench.roofline import walk
import kangaroo_torch.core.solver, kangaroo_torch.core.config
import kangaroo_torch.core.curve, kangaroo_torch.parallel.sharding
import kangaroo_torch.ops.jump_cuda
for name in [w["name"] for w in bench.load_benchmark()["workloads"]]:
    c = bench.cell(name)
    bench.driver(c)
    bench.readers(c)
bad = portbench.run.forbidden_modules()
print("forbidden:", bad)
sys.exit(1 if bad else 0)
"""

REF_PROBE = r"""
import sys
import portbench.reference.kangaroo, portbench.reference.secp256k1
import portbench.roofline.walk
bad = sorted(m for m in sys.modules if m.split(".")[0] == "kangaroo_torch")
print("port modules:", bad)
sys.exit(1 if bad else 0)
"""


def _probe(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_loads_no_jax():
    r = _probe(RUN_PROBE)
    assert r.returncode == 0, r.stdout + r.stderr


def test_reference_loads_nothing_of_the_port():
    r = _probe(REF_PROBE)
    assert r.returncode == 0, r.stdout + r.stderr


def test_forbidden_names_are_whole_top_level_names():
    from portbench import run

    saved = dict(sys.modules)
    try:
        sys.modules["jax_like_name"] = sys
        sys.modules["kangaroo_tpu_extra"] = sys
        assert run.forbidden_modules() == [
            m for m in ("flax", "jax", "jaxlib", "kangaroo_tpu")
            if m in saved or any(k.split(".")[0] == m for k in saved)]
        sys.modules["jax.numpy"] = sys
        assert "jax" in run.forbidden_modules()
    finally:
        for k in list(sys.modules):
            if k not in saved:
                del sys.modules[k]
