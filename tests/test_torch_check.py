"""-check of the port (kangaroo_torch/core/check.py) on the CPU.

run_self_check on the CPU runs the plain field ops, the batched k*G, the
plain walk against a host replay, the volume oracle through the plain
ops and the g++ build of field.cuh, and the walk kernel's g++-built
body against the plain walk at the kernel's geometry in both modes.
The operand pool is the JAX package's, and a corrupted lane of the
kernel body's output makes the lockstep fail.
"""

import shutil

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from kangaroo_tpu.core import check as jcheck  # noqa: E402
from kangaroo_torch.core import check  # noqa: E402
from kangaroo_torch.ops import host_kernel  # noqa: E402


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: cannot build csrc/ for the host")
    return host_kernel.load()


def test_structured_field_values_equal_jax():
    assert check.structured_field_values() == jcheck.structured_field_values()


def test_run_self_check_on_cpu(host, capsys):
    assert check.run_self_check(device="cpu") is True
    out = capsys.readouterr().out
    assert "Check: ALL OK" in out
    assert "Check: fe_inv volume OK (4096 inversions" in out


def _corrupt(name, index):
    """The host walk body with one output limb flipped."""
    def walk(*args, **kw):
        out = host_kernel.walk(*args, **kw)
        t = out[("px", "py", "d", "count", "dpx").index(name)]
        t.view(-1)[index] ^= 1
        return out
    return walk


@pytest.mark.parametrize("name,index", [("px", 5000), ("dpx", 123)])
def test_corrupted_lane_fails_lockstep(host, name, index, capsys):
    """One limb flipped in one lane of the kernel body's output: the
    lockstep reports the mismatch and fails; unflipped it passes."""
    kw = dict(device="cpu", nb_run=3, dp_size=2)
    assert check.kernel_lockstep_check(**kw) is True
    assert check.kernel_lockstep_check(walk=_corrupt(name, index),
                                       **kw) is False
    assert f"MISMATCH in {name}" in capsys.readouterr().out
