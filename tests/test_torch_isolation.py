"""kangaroo_torch and chip_smoke.py import neither JAX nor kangaroo_tpu,
nor the TPU probe scripts of scripts/, nor the JAX entry module
__graft_entry__.py.

A fresh interpreter imports every module of the port (the probe entry
points included: importing one runs nothing and needs no card) and the
smoke script, then checks sys.modules.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = r"""
import importlib, pkgutil, sys
import kangaroo_torch
names = [m.name for m in pkgutil.walk_packages(kangaroo_torch.__path__,
                                               "kangaroo_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
# the TPU probe scripts of scripts/, by package and by bare name
TPU_SCRIPTS = ("scripts", "pkbench", "probe_ops", "pkdelta", "pkinv",
               "layout_probe")
bad = sorted(m for m in sys.modules
             if m in ("jax", "__graft_entry__")
             or m.startswith(("jax.", "jaxlib", "kangaroo_tpu"))
             or m.split(".")[0] in TPU_SCRIPTS)
# the work-file, network, multi-device, STATS and graft-entry modules
# are among those imported
missing = [m for m in ("kangaroo_torch.io.backup", "kangaroo_torch.io.merge",
                       "kangaroo_torch.utils.packing",
                       "kangaroo_torch.native", "kangaroo_torch.core.check",
                       "kangaroo_torch.net.protocol",
                       "kangaroo_torch.net.server",
                       "kangaroo_torch.net.client",
                       "kangaroo_torch.parallel.sharding",
                       "kangaroo_torch.parallel.multihost",
                       "kangaroo_torch.parallel.weak_scaling",
                       "kangaroo_torch.stats_batch",
                       "kangaroo_torch.stats_summary",
                       "kangaroo_torch.graft_entry")
           if m not in names]
print(len(names), "modules;", "leaked:", bad, "missing:", missing)
sys.exit(1 if bad or missing or len(names) < 15 else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
