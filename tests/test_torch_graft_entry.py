"""kangaroo_torch.graft_entry against the JAX package's __graft_entry__.py.

The example inputs, entry()'s window and the sharded dry run on 8 CPU
shards are held to the JAX functions on the same inputs: the inputs as
carried across by kangaroo_torch.interop, the window against
jax.jit(fn)(*args), and the dry run's shards, concatenated in lane
order, against JAX's sharded tick on the 8-device virtual CPU mesh of
tests/conftest.py.  Integer data: tolerance 0 (py of the plain walk
compared mod p, the walk's contract).  A card asked for where there is
none raises; the module runs as a script on the CPU.  The JAX package
is imported inside the tests that hold the port to it, so the card test
runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_graft_entry.py -m cuda
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from kangaroo_torch import graft_entry, interop  # noqa: E402
from kangaroo_torch.ops import field, jump_ref  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARGS = ("px", "py", "d", "jx", "jy", "jd", "masks")
OUTS = ("px", "py", "d", "count", "dpx", "dpd", "step")


@pytest.fixture(scope="module")
def jax_entry():
    """__graft_entry__.py loaded from its path, as tests/test_sharding.py
    loads it."""
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_outputs_equal(got, want):
    """The port's window outputs (tensors) against JAX's (arrays)."""
    want = interop.from_numpy_state(
        {n: np.asarray(a) for n, a in zip(OUTS, want)}, "cpu")
    for name, a in zip(OUTS, got):
        b = want[name]
        if name == "py":
            a, b = field.canonicalize(a), field.canonicalize(b)
        assert a.shape == b.shape and torch.equal(a, b), name


def test_example_inputs_equal_jax(jax_entry):
    got = graft_entry._example_inputs(512, device="cpu")
    jargs = jax_entry._example_inputs(512)
    want = interop.from_numpy_state(
        {n: np.asarray(a) for n, a in zip(ARGS, jargs)}, "cpu")
    for name, a in zip(ARGS, got):
        assert a.dtype == torch.int32 and torch.equal(a, want[name]), name


def test_entry_window_equals_jax(jax_entry):
    import jax

    fn, args = graft_entry.entry(device="cpu")
    before = [a.clone() for a in args]
    out = fn(*args)
    jfn, jargs = jax_entry.entry()
    _assert_outputs_equal(out, jax.jit(jfn)(*jargs))
    assert out[0].shape == (16, 512)
    # pure: the arguments stay, a second call gives the same outputs
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    for a, b in zip(fn(*args), out):
        assert torch.equal(a, b)


def test_dry_run_equals_jax_mesh(jax_entry):
    """dryrun_multichip(8) on 8 CPU shards against JAX's sharded tick of
    the dry run (nb_run 2, inv_stop 64) on its 8-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kangaroo_tpu.parallel import sharding as jsharding

    outs = graft_entry.dryrun_multichip(8, device="cpu")
    assert len(outs) == 8 and all(o[0].shape == (16, 64) for o in outs)
    got = [torch.cat([o[k] for o in outs], dim=-1) for k in range(len(OUTS))]

    mesh = jsharding.make_mesh()
    px, py, d, jx, jy, jd, masks = jax_entry._example_inputs(512)
    px, py, d = jsharding.shard_herd(mesh, px, py, d)
    repl = jsharding.replicated(mesh)
    jx, jy, jd, masks = (jax.device_put(a, repl)
                         for a in (jx, jy, jd, masks))
    sc = jax.device_put(jnp.zeros((512,), jnp.uint32),
                        NamedSharding(mesh, P(jsharding.HERD_AXIS)))
    tick = jsharding.make_sharded_jump_steps(mesh, nb_run=2, inv_stop=64)
    _assert_outputs_equal(got, tick(px, py, d, jx, jy, jd, masks, sc))


def test_widened_herd_keeps_its_lanes():
    """The herd widened with repeats of its own lanes (as to whole kernel
    blocks on a card) walks its first lanes as the herd alone does: the
    plain walk, whose inversion spans every lane, on 512 lanes and on
    those lanes widened to 768 and to 1024."""
    px, py, d, *tabs = graft_entry._example_inputs(512, device="cpu")
    want = jump_ref.jump_steps_with_dp(px, py, d, *tabs, nb_run=4, slots=2)
    for quantum in (768, 1024):
        wide = graft_entry._whole_blocks(px, py, d, quantum=quantum)
        assert wide[0].shape == (16, quantum)
        assert torch.equal(wide[0][:, 512:], px[:, :quantum - 512])
        got = graft_entry._first_lanes(jump_ref.jump_steps_with_dp(
            *wide, *tabs, nb_run=4, slots=2), 512)
        for name, a, b in zip(OUTS, got, want):
            if name == "py":
                a, b = field.canonicalize(a), field.canonicalize(b)
            assert torch.equal(a, b), (quantum, name)


def test_card_asked_for_without_one_raises(monkeypatch, jax_entry):
    """The default device is the card: without one, entry() and the dry
    run raise the solver's message and run nothing on the CPU; fewer
    devices than asked for raise the JAX function's RuntimeError."""
    with pytest.raises(RuntimeError) as jerr:
        jax_entry.dryrun_multichip(9)  # the virtual mesh has 8 devices
    with pytest.raises(RuntimeError) as err:
        graft_entry.dryrun_multichip(9, device=["cpu"] * 8)
    assert str(err.value) == str(jerr.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(graft_entry.herd, "create_herd",
                        lambda *a, **k: calls.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(1)
    assert calls == []


def test_module_runs_on_cpu():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-m", "kangaroo_torch.graft_entry", "-device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines() == ["entry OK", "dryrun_multichip OK"]


@pytest.mark.cuda
def test_entry_and_dry_run_on_card():
    """On the card: entry()'s window (the kernel on a herd widened to one
    block) and the dry run on two shards of one card against the plain
    walk on the CPU, tolerance 0 (py mod p); two calls of fn equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernel has no CPU mode")
    from kangaroo_torch.ops import jump_cuda

    fn, args = graft_entry.entry()
    launches = jump_cuda.LAUNCHES
    out, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert jump_cuda.LAUNCHES == launches + 2
    want = jump_ref.jump_steps_with_dp(*[a.cpu() for a in args],
                                       nb_run=graft_entry.NB_RUN,
                                       slots=graft_entry.SLOTS)
    for name, a, b, c in zip(OUTS, out, want, again):
        assert torch.equal(a, c), name
        a = a.cpu()
        if name == "py":
            a, b = field.canonicalize(a), field.canonicalize(b)
        assert torch.equal(a, b), name
    outs = graft_entry.dryrun_multichip(2, device=["cuda:0", "cuda:0"])
    assert jump_cuda.LAUNCHES == launches + 4
    cpu = graft_entry._example_inputs(128, device="cpu")
    want = jump_ref.jump_steps_with_dp(*cpu, nb_run=graft_entry.DRY_NB_RUN,
                                       slots=graft_entry.SLOTS)
    for k, (name, b) in enumerate(zip(OUTS, want)):
        a = torch.cat([o[k].cpu() for o in outs], dim=-1)
        if name == "py":
            a, b = field.canonicalize(a), field.canonicalize(b)
        assert torch.equal(a, b), name
