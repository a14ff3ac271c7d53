"""kangaroo_torch's multi-device herd vs the JAX package's, on the CPU.

The port's lane shards (parallel/sharding.py) run here as 8 CPU shards,
the counterpart of the 8-device virtual CPU mesh that tests/conftest.py
gives JAX.  The sharded window must be bit-equal to JAX's sharded tick
(make_sharded_jump_steps over the mesh) and to its one-device walk; the
sharded solve must fill its table exactly like the JAX solver's 8-device
solve and like the port's own one-device solve (the walk, the drain in
walk order with global lanes, the dead-lane resets); a sharded -sym
solve's work files must be byte-equal to a one-device solve's.  Integer
data and file bytes: tolerance 0 throughout (py of the plain walk
compared mod p, the walk's contract).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

# the JAX solver's native table, loaded whatever the build race
pytestmark = pytest.mark.usefixtures("jax_native")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from kangaroo_tpu.core import curve as jcurve, herd as jherd  # noqa: E402
from kangaroo_tpu.core import solver as jsolver  # noqa: E402
from kangaroo_tpu.core.config import parse_config_file as jparse  # noqa: E402
from kangaroo_tpu.core.jumptable import create_jump_table  # noqa: E402
from kangaroo_tpu.ops import jump_ref as jref  # noqa: E402
from kangaroo_tpu.parallel import sharding as jsharding  # noqa: E402
from kangaroo_tpu.utils.rng import MT19937  # noqa: E402
from kangaroo_torch import interop  # noqa: E402
from kangaroo_torch.core import curve, solver  # noqa: E402
from kangaroo_torch.core.config import (  # noqa: E402
    ProblemConfig, parse_config_file)
from kangaroo_torch.ops import compact_cuda, field, jump_cuda  # noqa: E402
from kangaroo_torch.parallel import sharding  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
IN32 = os.path.join(ROOT, "fixtures", "in32.txt")
NAMES = ("px", "py", "d", "count", "dpx", "dpd", "step", "symclass")


def _jax_windows(fn, st, windows, sym):
    outs = []
    px, py, d, sc = st
    for _ in range(windows):
        o = fn(px, py, d, sc)
        px, py, d = o[0], o[1], o[2]
        if sym:
            sc = o[7]
        outs.append([np.asarray(a) for a in o])
    return outs


@pytest.mark.parametrize("sym", [False, True], ids=["plain", "sym"])
def test_sharded_tick_equals_jax(sym):
    """The inputs of tests/test_sharding.py:25 (n 128 = 16 lanes per
    shard, nb_run 4, inv_stop 16), two windows in a row (the second
    starts from mixed classes in -sym), over 8 shards."""
    n, nb_run, rp = 128, 4, 48
    jt = [jnp.asarray(a) for a in create_jump_table(rp, sym).as_arrays()]
    masks = jnp.asarray(jref.dp_limb_masks(4))
    px, py, d = (jnp.asarray(a) for a in jherd.create_herd(
        n, rp, ((1 << rp) - 1) >> 1, jcurve.mul(0xABCDEF99), 0, MT19937(3),
        symmetry=sym))
    sc = jnp.zeros((n,), jnp.uint32)

    def single(px, py, d, sc):
        return jref.jump_steps_with_dp(
            px, py, d, *jt, masks, nb_run=nb_run, inv_stop=16,
            symmetry=sym, symclass=sc if sym else None)

    mesh = jsharding.make_mesh()
    repl = jsharding.replicated(mesh)
    sjt = [jax.device_put(a, repl) for a in jt + [masks]]
    fn = jsharding.make_sharded_jump_steps(mesh, nb_run=nb_run, inv_stop=16,
                                           symmetry=sym)

    def sharded(px, py, d, sc):
        return fn(px, py, d, *sjt, sc)

    lanes = NamedSharding(mesh, P(jsharding.HERD_AXIS))
    want_single = _jax_windows(single, (px, py, d, sc), 2, sym)
    want_mesh = _jax_windows(
        sharded, jsharding.shard_herd(mesh, px, py, d)
        + (jax.device_put(sc, lanes),), 2, sym)

    shards = sharding.make_shards(sharding.resolve_devices(8, "cpu"), n)
    assert [(s.lo, s.hi) for s in shards] == [(16 * i, 16 * i + 16)
                                              for i in range(8)]
    st = interop.from_numpy_state(
        dict(px=px, py=py, d=d, sc=sc), "cpu")
    herds = [list(h) + [h[3] if sym else None] for h in sharding.shard_herd(
        shards, st["px"], st["py"], st["d"], st["sc"])]
    tables = sharding.replicate(shards, *(
        interop.from_numpy_state(dict(t=np.asarray(a)), "cpu")["t"]
        for a in jt + [masks]))
    tick = sharding.make_sharded_jump_steps(shards, nb_run, 2, sym)
    for w in range(2):
        outs = tick(herds, tables)
        for h, o in zip(herds, outs):
            h[:3] = o[:3]
            if sym:
                h[3] = o[7]
        got = [torch.cat([o[k] for o in outs], dim=-1)
               for k in range(len(outs[0]))]
        for name, g, a, b in zip(NAMES, got, want_single[w], want_mesh[w]):
            if name == "py" and not sym:  # the plain walk's py is relaxed
                g = field.canonicalize(g)
                a, b = (field.canonicalize(torch.from_numpy(
                    x.astype(np.int32))).numpy() for x in (a, b))
            g = g.numpy().astype(np.uint32)
            np.testing.assert_array_equal(g, np.asarray(a).astype(np.uint32),
                                          err_msg=f"window {w}: {name}")
            np.testing.assert_array_equal(g, np.asarray(b).astype(np.uint32),
                                          err_msg=f"window {w}: {name}")
    assert int(got[3].sum()) > 0  # DPs were captured


def _port(nd, **kw):
    return solver.KangarooSolver(parse_config_file(IN32), solver.SolverOptions(
        nb_kangaroo=512, dp_size=4, nb_run=16, device="cpu", quiet=True,
        n_devices=nd, **kw))


@pytest.mark.parametrize("sym,seed,nds", [
    (False, 36, (8, 1)), (True, 8, (8, 1)), (False, 36, (2,))],
    ids=["plain", "sym", "plain-2"])
def test_sharded_solve_equals_jax(sym, seed, nds, monkeypatch):
    """in32 at 512 lanes over 8 shards: the JAX solver's 8-device solve
    and the port's own solve on nds shards fill the same table, with the
    same dead, lost and count, and find the same key (seed 36 solves
    in 5 ticks after 3 dead lanes, -sym seed 8 in 3 after 2).  Every
    shard's tick is pulled through sharding.queue_compact, as a
    compact_cuda.Plain on the CPU, and read by sharding.compact in the
    order it was queued; only the last tick's may be left unread."""
    js = jsolver.KangarooSolver(jparse(IN32), jsolver.SolverOptions(
        nb_kangaroo=512, dp_size=4, nb_run=16, seed=seed, n_devices=8,
        backend="xla", quiet=True, symmetry=sym))
    jres = js.solve(0, max_ticks=5)
    assert js._exec_cache[0][7] == 8  # the JAX solve ran on 8 devices
    assert jres is not None and jres.private_key == 0xB862A62E
    queue, read = sharding.queue_compact, sharding.compact
    for nd in nds:
        queued, pulled = [], []

        def spy_queue(sh, wins, slots, nb_run, out=queued):
            out.append((sh.lo, queue(sh, wins, slots, nb_run)))
            return out[-1][1]

        def spy_read(sh, q, slots, nb_run, out=pulled):
            out.append((sh.lo, q))
            return read(sh, q, slots, nb_run)

        monkeypatch.setattr(sharding, "queue_compact", spy_queue)
        monkeypatch.setattr(sharding, "compact", spy_read)
        ts = _port(nd, seed=seed, symmetry=sym)
        assert len(ts.shards) == nd
        res = ts.solve(0, max_ticks=5)
        assert len(queued) == ts.stats.ticks * nd
        assert all(isinstance(q, compact_cuda.Plain) for _, q in queued)
        assert pulled == queued[:len(pulled)]
        assert len(pulled) >= len(queued) - nd
        assert ts.hash_table.export() == js.hash_table._export(), nd
        assert (ts.stats.dead, ts.stats.lost, ts.stats.count) == (
            js.stats.dead, js.stats.lost, js.stats.count), nd
        assert ts.stats.dead > 0 and ts.hash_table.n_items() > 0
        assert res is not None
        assert (res.private_key, res.sign_info, res.variant) == (
            jres.private_key, jres.sign_info, jres.variant)


def _sym_problem():
    width = (1 << 18) - 1
    start = 0xA40000
    return ProblemConfig(start, start + width,
                         [curve.mul(start + 201777)]), start + 201777


def _sym_solver(nd, seed, **kw):
    cfg, _ = _sym_problem()
    return solver.KangarooSolver(cfg, solver.SolverOptions(
        nb_kangaroo=128, dp_size=2, nb_run=8, seed=seed, device="cpu",
        n_devices=nd, symmetry=True, quiet=True, **kw))


def test_sharded_save_and_resume_equal_one_device(tmp_path):
    """The counterpart of tests/test_sharding.py:100 (-sym, resets
    firing, a mid-run save, a resume): a work file saved with its herd
    (-ws) every tick by an 8-shard solve is byte-equal to a one-device
    solve's (its time field aside), and resumes to the key on 8 shards;
    a client-mode run (DPs to a sink, kangaroo-only HEADK saves) sends
    the same wire records and writes the same HEADK file on 8 shards as
    on one device."""
    files, sent = {}, {}
    for nd in (8, 1):
        path = str(tmp_path / f"nd{nd}.work")
        s = _sym_solver(nd, 22, work_file=path, save_kangaroo=True,
                        save_period=-1)
        s.solve(0, max_ticks=3)
        assert s.stats.dead > 0 and s.stats.lost == 0  # resets fired
        files[nd] = open(path, "rb").read()
        kpath = str(tmp_path / f"nd{nd}.kang")
        c = _sym_solver(nd, 22, work_file=kpath, save_period=-1)
        sent[nd] = []
        c.solve(0, max_ticks=3,
                dp_sink=lambda raw, m, out=sent[nd]: out.append(raw))
        files[f"k{nd}"] = open(kpath, "rb").read()
    from kangaroo_torch.io import backup

    time_field = slice(148, 156)  # HEADW's f64 time
    for f in (files[8], files[1]):
        assert f[:4] == backup.HEADW.to_bytes(4, "little")
    assert (files[8][:time_field.start] + files[8][time_field.stop:]
            == files[1][:time_field.start] + files[1][time_field.stop:])
    assert files["k8"] == files["k1"]
    assert sent[8] == sent[1] and b"".join(sent[8])
    lw = backup.load_work(str(tmp_path / "nd8.work"))
    assert lw.kangaroos is not None and lw.kangaroos[0].shape[1] == 128
    r = solver.KangarooSolver.from_work(lw, solver.SolverOptions(
        nb_kangaroo=128, nb_run=8, seed=23, device="cpu", n_devices=8,
        symmetry=True, quiet=True))
    res = r.solve(0, max_ticks=4000)
    assert res is not None and res.private_key == _sym_problem()[1]
    assert r.stats.lost == 0


@pytest.mark.parametrize("nk", [2, 6, 14, 96, 130, 510, 512, 1000])
def test_shard_rule_equals_jax(nk):
    """The shard count for awkward lane counts: the port's rule against
    the JAX solver's (kangaroo_tpu/core/solver.py:431-435, 8 devices),
    through the solver on the CPU; on a card the unit is the lane
    quantum."""
    for n_devices in (0, 1, 3, 8):
        nd = n_devices or 8
        nd = min(nd, 8, nk)
        while nd > 1 and nk % nd:
            nd -= 1
        assert sharding.shard_count(min(n_devices or 8, 8), nk) == nd
        if n_devices and nk % 2 == 0:
            s = solver.KangarooSolver(parse_config_file(IN32),
                                      solver.SolverOptions(
                                          nb_kangaroo=nk, device="cpu",
                                          n_devices=n_devices, quiet=True))
            assert len(s.shards) == nd
            assert [(x.lo, x.hi) for x in s.shards] == [
                (i * nk // nd, (i + 1) * nk // nd) for i in range(nd)]
    q = jump_cuda.LANE_QUANTUM
    assert sharding.shard_count(4, 3 * q, q) == 3
    assert sharding.shard_count(2, 3 * q, q) == 1
    assert sharding.shard_count(8, 12 * q, q) == 6
    assert sharding.shard_count(2, q, q) == 1


def test_resolve_devices():
    cpu = torch.device("cpu")
    assert sharding.resolve_devices(0, "cpu") == [cpu]
    assert sharding.resolve_devices(8, "cpu") == [cpu] * 8
    assert sharding.resolve_devices(1, ["cpu", "cpu"]) == [cpu]
    assert sharding.resolve_devices(0, ("cpu", "cpu")) == [cpu, cpu]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.resolve_devices(2, "cuda")
