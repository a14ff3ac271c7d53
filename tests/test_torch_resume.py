"""kangaroo_torch checkpoint and resume vs the JAX solver, on the CPU.

A solve of N ticks, then save, load and resume M ticks: the resumed
herd, table, count and dead count bit-equal to the JAX solver doing the
same (with the same, a larger and a smaller -nk; plain and -sym); a -sym
mismatch rejected; the background save round trip; -wsplit splits that
merge to the key; a repeated same-key solve() that continues; the CLI's
work-file flags on -device cpu, and on -device cuda without a card an
error.  Tolerance 0: integer data and file bytes.
"""

import functools
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from tests.test_torch_jax_native import jax_native  # noqa: E402,F401

# the JAX solver's native table, loaded whatever the build race
pytestmark = pytest.mark.usefixtures("jax_native")

from kangaroo_tpu.core import curve as jcurve  # noqa: E402
from kangaroo_tpu.core.config import ProblemConfig as JConfig  # noqa: E402
from kangaroo_tpu.core.solver import KangarooSolver as JSolver  # noqa: E402
from kangaroo_tpu.core.solver import SolverOptions as JOptions  # noqa: E402
from kangaroo_tpu.io import backup as jbackup  # noqa: E402
from kangaroo_torch import cli  # noqa: E402
from kangaroo_torch.core import curve  # noqa: E402
from kangaroo_torch.core.config import ProblemConfig  # noqa: E402
from kangaroo_torch.core.solver import (  # noqa: E402
    KangarooSolver, SolverOptions, SymmetryMismatch)
from kangaroo_torch.io import backup, merge  # noqa: E402
from kangaroo_torch.utils.packing import canon_mod_p  # noqa: E402

START = 0x5000000
WIDTH = (1 << 20) - 1
K_PRIV = START + (int(WIDTH * 0.43) | 1)
RUN = dict(nb_run=8, quiet=True)


def port_solver(nk=64, symmetry=False, seed=5, **kw):
    cfg = ProblemConfig(START, START + WIDTH, [curve.mul(K_PRIV)])
    return KangarooSolver(cfg, SolverOptions(
        nb_kangaroo=nk, dp_size=2, seed=seed, symmetry=symmetry,
        device="cpu", **RUN, **kw))


def jax_solver(nk=64, symmetry=False, seed=5, **kw):
    cfg = JConfig(START, START + WIDTH, [jcurve.mul(K_PRIV)])
    return JSolver(cfg, JOptions(
        nb_kangaroo=nk, dp_size=2, seed=seed, symmetry=symmetry,
        n_devices=1, backend="xla", **RUN, **kw))


def jax_resumed(lw, nk, symmetry=False):
    """The JAX CLI's -i load path (kangaroo_tpu/cli.py:342-366)."""
    s = JSolver(JConfig(lw.range_start, lw.range_end, [lw.key]), JOptions(
        nb_kangaroo=nk, dp_size=lw.dp_size, seed=6, symmetry=symmetry,
        n_devices=1, backend="xla", **RUN))
    s.hash_table = lw.hash_table
    s.offset_count, s.offset_time = lw.count, lw.time
    s.resumed = True
    s.loaded_kangaroos = lw.kangaroos
    return s


def port_resumed(lw, nk, symmetry=False):
    return KangarooSolver.from_work(lw, SolverOptions(
        nb_kangaroo=nk, seed=6, symmetry=symmetry, device="cpu", **RUN))


def host(state):
    """(px, canonical py, d) as int64 numpy arrays."""
    px, py, d = (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                 for a in state)
    return (px.astype(np.int64), canon_mod_p(py).astype(np.int64),
            d.astype(np.int64))


def assert_same_solvers(ts, js, tres, jres):
    assert ts.hash_table.export() == js.hash_table._export()
    assert (ts.stats.count, ts.stats.dead, ts.stats.lost) == (
        js.stats.count, js.stats.dead, js.stats.lost)
    for a, b in zip(host(ts.last_state), host(js.last_state)):
        np.testing.assert_array_equal(a, b)
    assert (tres is None) == (jres is None)
    if tres is not None:
        assert tres.private_key == jres.private_key == K_PRIV


@pytest.mark.parametrize("symmetry,nk,nk_new", [
    (False, 64, 64), (False, 64, 32), (False, 32, 64), (True, 64, 64)],
    ids=["plain", "plain-smaller-nk", "plain-larger-nk", "sym"])
def test_resume_equals_jax_solver(tmp_path, symmetry, nk, nk_new):
    """Save after 5 ticks, load, resume 4 ticks at nk_new: both packages'
    files byte-equal, and the resumed herd, table and counts bit-equal
    (a surplus is cut at the tail, a shortfall filled by fresh lanes
    whose parity is their type).  Two lane counts only: the JAX solver
    compiles its tick for each (about 17 s on the CPU)."""
    ts, js = (port_solver(nk, symmetry=symmetry),
              jax_solver(nk, symmetry=symmetry))
    assert (ts.solve(0, max_ticks=5) is None) == (
        js.solve(0, max_ticks=5) is None)
    tp, jp = str(tmp_path / "t.work"), str(tmp_path / "j.work")
    backup.save_work(tp, ts, *ts.last_state, ts.stats.count, 1.5,
                     save_kangaroo=True)
    jbackup.save_work(jp, js, *(np.asarray(a) for a in js.last_state),
                      js.stats.count, 1.5, save_kangaroo=True)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    lw = backup.load_work(tp)
    t2 = port_resumed(lw, nk_new, symmetry)
    j2 = jax_resumed(jbackup.load_work(jp, native=True), nk_new, symmetry)
    assert t2.hash_table.n_items() == ts.hash_table.n_items() > 0
    tres, jres = t2.solve(0, max_ticks=4), j2.solve(0, max_ticks=4)
    assert_same_solvers(t2, j2, tres, jres)
    assert t2.last_state[0].shape[1] == nk_new
    assert t2.stats.count == lw.count + t2.stats.ticks * nk_new * 8
    assert t2.stats.herd_time >= 0 and t2.loaded_kangaroos is None


def test_resume_solves_to_key(tmp_path):
    ts = port_solver()
    ts.solve(0, max_ticks=4)
    path = str(tmp_path / "w.work")
    backup.save_work(path, ts, *ts.last_state, ts.stats.count, 1.0,
                     save_kangaroo=True)
    for symmetry in (True,):  # the other -sym setting is refused
        with pytest.raises(SymmetryMismatch, match="saved without -sym"):
            port_resumed(backup.load_work(path), 64, symmetry)
    res = port_resumed(backup.load_work(path), 64).solve(0, max_ticks=4000)
    assert res is not None and res.private_key == K_PRIV


def test_same_key_solve_continues_like_jax():
    """A repeated solve() of the same key keeps the table and the count
    and walks on from last_state, bit-equal to the JAX solver doing the
    same; a new key starts afresh."""
    ts, js = port_solver(), jax_solver()
    ts.solve(0, max_ticks=4)
    js.solve(0, max_ticks=4)
    first = host(ts.last_state)
    n1, c1 = ts.hash_table.n_items(), ts.stats.count
    tres, jres = ts.solve(0, max_ticks=3), js.solve(0, max_ticks=3)
    assert_same_solvers(ts, js, tres, jres)
    assert ts.stats.count == c1 + 3 * 64 * 8
    assert ts.hash_table.n_items() >= n1
    assert not np.array_equal(first[0], host(ts.last_state)[0])
    # a new key resets the table, the count and the time
    ts.cfg.keys.append(curve.mul(K_PRIV + 2))
    ts.solve(1, max_ticks=1)
    assert ts.stats.count == 64 * 8 and ts.stats.ticks == 1


def test_background_save_round_trip(tmp_path):
    """Saves every tick on a writer thread: the file's herd is the last
    snapshot the solver took, equal to the JAX solver's file's herd and
    count; it resumes to the key."""
    wf, jwf = str(tmp_path / "bg.work"), str(tmp_path / "jbg.work")
    ts = port_solver(work_file=wf, save_period=0, save_kangaroo=True)
    js = jax_solver(work_file=jwf, save_period=0, save_kangaroo=True)
    ts.solve(0, max_ticks=6)
    js.solve(0, max_ticks=6)
    js.finish_save()
    assert ts.stats.saves >= 1 and ts.stats.save_stall >= 0
    lw, jlw = backup.load_work(wf), jbackup.load_work(jwf, native=True)
    assert lw.nb_kangaroo == 64 and lw.count == jlw.count == 6 * 64 * 8
    for a, b, c in zip(host(lw.kangaroos), host(ts._snap),
                       host(jlw.kangaroos)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    res = port_resumed(lw, 64).solve(0, max_ticks=4000)
    assert res is not None and res.private_key == K_PRIV


def test_wsplit_files_merge_to_key(tmp_path):
    """-wsplit: each save freezes the table into a timestamped file and
    the walk goes on with a fresh one; merging the splits and a final
    save recovers the collision offline."""
    wdir = tmp_path / "splits"
    wdir.mkdir()
    wf = str(wdir / "w.work")
    ts = port_solver(work_file=wf, save_period=0, split_work_file=True)
    res = ts.solve(0, max_ticks=4000)
    splits = glob.glob(str(wdir / "w.work_*"))
    assert splits and ts.stats.saves == len(splits)
    if res is None:
        backup.save_work(wf, ts, None, None, None, ts.stats.count,
                         ts.stats.time)
        _, res, _ = merge.merge_dir(str(wdir), str(tmp_path / "m.work"))
    assert res is not None and res.private_key == K_PRIV


def run_cli(capsys, *args):
    rc = cli.main(list(args))
    return rc, capsys.readouterr().out


def test_cli_work_file_flags_on_cpu(tmp_path, capsys, monkeypatch):
    """-w/-wi/-ws/-wt save, -winfo, -wcheck and -i resume to the key; -i
    with the other -sym setting exits -1 with the JAX message; -wsplit
    files merge with -wmdir and -wm, into a -wpartcreate directory too.
    The herd seed is fixed, so that the aborted runs stop unsolved."""
    from kangaroo_torch.core import solver as solver_mod

    monkeypatch.setattr(solver_mod, "SolverOptions",
                        functools.partial(SolverOptions, seed=5))
    cfg = tmp_path / "in.txt"
    cfg.write_text(f"{START:X}\n{START + WIDTH:X}\n"
                   f"{curve.get_public_key_hex(curve.mul(K_PRIV), True)}\n")
    wf = str(tmp_path / "a.work")
    base = ("-device", "cpu", "-nk", "64", "-d", "2", "-nbrun", "8")
    rc, out = run_cli(capsys, *base, "-w", wf, "-wi", "0", "-ws", "-wt",
                      "3000", "-m", "0.2", str(cfg))
    assert rc == 1 and "Aborted" in out and os.path.exists(wf)
    rc, out = run_cli(capsys, "-winfo", wf)
    assert rc == 0 and out.strip() == jbackup.work_info(wf)
    assert "Kangaroos : 64 " in out
    rc, out = run_cli(capsys, "-device", "cpu", "-wcheck", wf)
    n = backup.load_work(wf, load_kangaroos=False).hash_table.n_items()
    assert rc == 0 and f"CheckWorkFile: {n} DPs, 0 wrong" in out
    rc, out = run_cli(capsys, *base, "-sym", "-i", wf)
    assert rc == -1 and (f"{wf}: work file was saved without -sym; rerun "
                         f"without -sym to resume it") in out
    rc, out = run_cli(capsys, *base, "-i", wf)
    assert rc == 0 and f"Priv: 0x{K_PRIV:X}" in out

    wdir = tmp_path / "splits"
    wdir.mkdir()
    rc, out = run_cli(capsys, *base, "-w", str(wdir / "s.work"), "-wi", "0",
                      "-wsplit", "-m", "0.5", str(cfg))
    splits = sorted(glob.glob(str(wdir / "s.work_*")))
    assert rc == 1 and len(splits) >= 2
    rc, out = run_cli(capsys, "-wmdir", str(wdir), str(tmp_path / "m.work"))
    assert rc == 0 and os.path.exists(tmp_path / "m.work")
    rc, out = run_cli(capsys, "-wm", splits[0], splits[1],
                      str(tmp_path / "m2.work"))
    assert rc == 0 and "MergeWork: Done" in out
    part = str(tmp_path / "parts")
    rc, _ = run_cli(capsys, "-wpartcreate", part)
    assert rc == 0 and os.path.isdir(part)
    for s in splits[:2]:
        rc, _ = run_cli(capsys, "-wm", part, s)
        assert rc == 0
    rc, out = run_cli(capsys, "-winfo", part)
    assert rc == 0 and out.strip() == jbackup.work_info(part)
    rc, out = run_cli(capsys, "-device", "cpu", "-wcheck", part)
    assert rc == 0 and ", 0 wrong" in out


def test_cli_work_file_flags_need_the_card_on_cuda(tmp_path, capsys):
    """-device cuda (the default) without a card: -wcheck, -i and a
    saving solve raise; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is not an error here")
    ts = port_solver()
    ts.solve(0, max_ticks=2)
    wf = str(tmp_path / "w.work")
    backup.save_work(wf, ts, *ts.last_state, ts.stats.count, 1.0,
                     save_kangaroo=True)
    cfg = tmp_path / "in.txt"
    cfg.write_text(f"{START:X}\n{START + WIDTH:X}\n"
                   f"{curve.get_public_key_hex(curve.mul(K_PRIV), True)}\n")
    for args in (["-wcheck", wf], ["-i", wf], ["-w", wf, str(cfg)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
    assert "not yet ported" not in capsys.readouterr().out
