"""STATS batches of the port (kangaroo_torch.stats_batch, stats_summary)
against the JAX package's solver and scripts, on the CPU.

A batch solves several keys with one solver object, resetting its table
after each key (scripts/stats_batch.py).  For keys 0 and 1 of the in28
fixture, the port's rows (private key, jumps, dead lanes, ticks) must
equal the JAX solver's, driven the same way, in plain and -sym: the
new-key path of solve() resets what the JAX one resets.  The JAX solver
keeps `stats.lost` across keys while the port's stats restart per key;
both stay 0 here (the capture slots are sized for it), and the port's
per-key count is what a batch prints.

stats_summary must print what scripts/stats_summary.py prints, on the
committed transcripts and on one that format_row wrote.  The card test
solves 8 keys of the 1000-key fixture through the walk kernel at
chip_smoke.py phase 11's options, against the stock binary's Priv lines.
"""

import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

from kangaroo_torch import stats_batch, stats_summary  # noqa: E402
from kangaroo_torch.core.config import parse_config_file  # noqa: E402
from kangaroo_torch.core.solver import SolverOptions  # noqa: E402

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
IN28 = os.path.join(ROOT, "fixtures", "in28_8.txt")
IN40 = os.path.join(ROOT, "fixtures", "in40_1000.txt")
OURS = os.path.join(ROOT, "hw_evidence", "stats_ours1000_r05.txt")
REF = os.path.join(ROOT, "hw_evidence", "stats_ref1000_r05.txt")
# tests/test_fixtures.py's in28 options; each key solves in < 20 ticks
OPTS = dict(nb_kangaroo=256, dp_size=3, nb_run=16, quiet=True)
SEED0 = 23
# -sym's keys draw from seed 9 + i: their dead lanes come back in
# batches of at most 8 with a wild lane in each, so the JAX solver
# compiles one dead-lane reset shape (from seed 23 it meets four, each a
# k*G compile of ~12 s on one core)
SYM_SEED0 = 9
MAX_TICKS = 400


def in28_key(i):
    """The in28 fixture's rule for key i."""
    return 0x10000000 + (((i + 1) * 0x9E3779B9) % (1 << 28))


def _run(args, timeout=120, env=None):
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("sym", [False, True], ids=["plain", "sym"])
def test_multi_key_rows_equal_jax_solver(sym):
    """Keys 0 and 1 through one solver object each, seed 23 + i (-sym:
    9 + i), table reset after each key: rows equal with tolerance 0.
    The second key redraws dead lanes in both modes.  (The JAX package is
    imported here: the card host that runs the card test has no JAX.)"""
    jsolver = pytest.importorskip("kangaroo_tpu.core.solver")
    from kangaroo_tpu.core.config import parse_config_file as jparse
    from tests.test_torch_jax_native import require_jax_native

    require_jax_native()  # the JAX solver's native table

    seed0 = SYM_SEED0 if sym else SEED0
    js = jsolver.KangarooSolver(jparse(IN28), jsolver.SolverOptions(
        n_devices=1, backend="xla", symmetry=sym, **OPTS))
    want = []
    for i in (0, 1):
        js.opts.seed = seed0 + i
        res = js.solve(i, max_ticks=MAX_TICKS)
        assert res is not None, f"JAX solver: key {i} unsolved"
        want.append((res.private_key, js.stats.count, js.stats.dead,
                     js.stats.count // (OPTS["nb_kangaroo"] * OPTS["nb_run"])))
        js.hash_table.reset()
    rows = stats_batch.run_batch(
        parse_config_file(IN28),
        SolverOptions(device="cpu", symmetry=sym, **OPTS), [0, 1],
        seed0=seed0, max_ticks=MAX_TICKS)
    assert [(r.priv, r.count, r.dead, r.ticks) for r in rows] == want
    assert rows[1].dead > 0
    assert [r.key for r in rows] == [0, 1]
    assert [r.priv for r in rows] == [in28_key(0), in28_key(1)]
    # the second key ran on a solver that had solved the first
    assert all(r.count == r.ticks * 256 * 16 for r in rows)


def test_batch_tick_bound_gives_abort_row():
    """A key stopped by max_ticks comes back with priv None and prints
    the JAX script's ABORT line; the batch goes on to the next key."""
    rows = stats_batch.run_batch(parse_config_file(IN28),
                                 SolverOptions(device="cpu", **OPTS), [2, 3],
                                 seed0=SEED0, max_ticks=1)
    assert [(r.key, r.priv, r.ticks) for r in rows] == [(2, None, 1),
                                                        (3, None, 1)]
    assert stats_batch.format_row(rows[0], 1.0) == "key 2: ABORT"


def test_summary_equals_jax_script_on_committed_transcripts():
    jax_out = _run([os.path.join("scripts", "stats_summary.py"), OURS,
                    "--ref", REF])
    port_out = _run(["-m", "kangaroo_torch.stats_summary", OURS, "--ref",
                     REF])
    assert jax_out.returncode == port_out.returncode == 0, (
        jax_out.stderr, port_out.stderr)
    assert port_out.stdout == jax_out.stdout
    s = stats_summary.summarize([OURS], REF)
    # the transcript as committed: 535 keys (its r05 summary file was
    # written at 468)
    assert (s["n"], s["common"]) == (535, 535)
    assert (round(s["avg"], 3), round(s["dead"], 2)) == (2.271, 1.62)
    assert (round(s["ref_avg"], 3), round(s["ref_dead"], 2)) == (2.186, 1.34)
    assert round(s["ratio"], 4) == 1.0390
    # --detail adds two lines after the same output
    more = _run(["-m", "kangaroo_torch.stats_summary", OURS, "--ref", REF,
                 "--detail"])
    assert more.stdout.startswith(jax_out.stdout)
    extra = more.stdout[len(jax_out.stdout):].splitlines()
    assert extra[0].startswith("  standard errors: ")
    assert extra[1] == "  private keys equal to the reference's: 535 of 535"
    assert len(extra) == 2
    assert 0.04 < s["ours_se"] < 0.06 and 0.04 < s["ref_se"] < 0.06


def test_stock_stream_reads_every_key():
    """The stock stream: 1000 keys, each with its Priv line; over all of
    them 2.213*sqrt(N) and 1.38 dead per key (ROADMAP's stock figures)."""
    ref = stats_summary.read_ref(REF)
    assert sorted(ref) == list(range(1000))
    assert all(p is not None for _, _, p in ref.values())
    assert ref[0][2] == 0xB779B97F4A and ref[999][2] == 0x1337C993910
    avg = sum(o for o, _, _ in ref.values()) / 1000 / 2.0 ** 20
    assert round(avg, 3) == 2.213
    assert round(sum(d for _, d, _ in ref.values()) / 1000, 2) == 1.38


def test_summary_reads_format_row_transcript(tmp_path):
    """Rows written by format_row: both summaries read them alike."""
    ref = stats_summary.read_ref(REF)
    sqrt_n = 2.0 ** 20
    rows = [stats_batch.Row(k, ref[k][2], int(ref[k][0] * (1 + k / 10)),
                            k % 3, k % 2, 70 + k, 0.5, 0.25, 0.8,
                            2.16 * sqrt_n, 4)
            for k in (0, 1, 7, 12)]
    path = tmp_path / "ours.txt"
    path.write_text("\n".join(stats_batch.format_row(r, sqrt_n)
                              for r in rows) + "\nkey 13: ABORT\n")
    s = stats_summary.summarize([str(path)], REF)
    assert (s["n"], s["common"]) == (4, 4)
    want = sum(round(r.count / sqrt_n, 3) for r in rows) / 4
    assert s["ours_avg"] == pytest.approx(want, rel=0, abs=1e-12)
    assert s["ours_dead"] == sum(r.dead for r in rows) / 4
    assert s["same_priv"] == 4
    jax_out = _run([os.path.join("scripts", "stats_summary.py"), str(path),
                    "--ref", REF])
    port_out = _run(["-m", "kangaroo_torch.stats_summary", str(path),
                     "--ref", REF])
    assert jax_out.returncode == 0, jax_out.stderr
    assert port_out.stdout == jax_out.stdout


def test_entry_point_on_cpu():
    """The JAX script's positional arguments with -device cpu: one key
    of in28, its line and the summary."""
    out = _run(["-m", "kangaroo_torch.stats_batch", IN28, "8", "3", "16",
                "1", "1", "-device", "cpu"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    key_lines = [ln for ln in lines if ln.startswith("key ")]
    assert len(key_lines) == 1
    m = stats_summary.OURS.match(key_lines[0])
    assert m and int(m.group(1)) == 0
    assert key_lines[0].startswith(f"key  0: priv=0x{in28_key(0):X} ")
    assert "SUMMARY: 1 keys, range 2^28, nk=2^8, dp=3" in lines
    assert any(ln.startswith("ops/sqrtN mean ") for ln in lines)


def test_entry_point_without_a_card_fails():
    """Asked for the card (the default) where there is none: a message
    and a non-zero exit, and no key solved on the CPU instead."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["-m", "kangaroo_torch.stats_batch", IN28, "8", "3", "16",
                "1", "1"], env=env)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "key " not in out.stdout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("sym", [False, True], ids=["plain", "sym"])
def test_in40_keys_on_the_card(cuda, sym):
    """8 keys of in40_1000 at phase 11's options (one 8192-lane block,
    dp 4, 4 steps a tick) through the walk kernel only: each key the
    stock binary's."""
    from kangaroo_torch.ops import jump_cuda, jump_ref

    ref = stats_summary.read_ref(REF)
    cfg = parse_config_file(IN40)
    jump_cuda.LAUNCHES = jump_cuda.SYM_LAUNCHES = jump_ref.CALLS = 0
    rows = stats_batch.run_batch(
        cfg, SolverOptions(nb_kangaroo=1 << 13, dp_size=4, nb_run=4,
                           windows_per_tick=1, device="cuda", quiet=True,
                           symmetry=sym), range(8), seed0=0x5EED)
    launches = jump_cuda.SYM_LAUNCHES if sym else jump_cuda.LAUNCHES
    other = jump_cuda.LAUNCHES if sym else jump_cuda.SYM_LAUNCHES
    assert launches == sum(r.ticks for r in rows) and other == 0
    assert jump_ref.CALLS == 0
    assert [r.priv for r in rows] == [ref[k][2] for k in range(8)]
    assert all(math.isfinite(r.walk_s) for r in rows)
