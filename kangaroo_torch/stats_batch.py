"""STATS batches: solve the keys of a multi-key config through one solver
and hold the mean work to a key against the kangaroo model.

    python -m kangaroo_torch.stats_batch <config> [nk_log2] [dp] [nbrun]
        [kw] [maxkeys] [startkey] [-sym] [-device cuda|cpu]

The port's counterpart of scripts/stats_batch.py (the reference's STATS
build, Kangaroo.cpp:1010-1076), with the same positional arguments: the
herd is 2^nk_log2 lanes (default 2^16), dp -1 is the auto DP, nbrun and
kw 0 the auto launch window and windows per tick, and the keys solved
are startkey .. maxkeys-1 (maxkeys 0: to the last).  -sym walks the
classes {P, -P}; -device picks where the walk runs (default cuda; with
no card that is an error, and nothing falls back to the CPU).  Each key
draws its herd from the time seed, as the JAX script's do.

Prints one line per key, whose head up to `dead=` is the JAX script's
letter for letter (stats_summary reads both), then the JAX script's
three summary lines and the port's own: the mean of ops/sqrt(N) with its
standard error, and the dead lanes and ticks per key.

The work to a key is counted in ticks of nk * nbrun * kw jumps, and the
loop drains tick T-1 while tick T walks, so a key's count carries up to
~3 ticks of lag: statistics need ticks well below sqrt(N).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Iterable, List, NamedTuple, Optional

from .core.config import ProblemConfig, parse_config_file
from .core.solver import KangarooSolver, SolverOptions, resolve_device
from .stats_summary import mean_se


class Row(NamedTuple):
    key: int                   # key index in the config
    priv: Optional[int]        # the private key; None when the solve stopped
    count: int                 # jumps to the key
    dead: int                  # dead lanes redrawn
    dup: int                   # of them, duplicate DPs (stats.dup)
    ticks: int
    herd_s: float              # herd creation seconds
    walk_s: float              # walk loop seconds
    wall_s: float              # the solve() call's seconds
    expected: float            # the model's jumps at this DP and herd
    dp: int                    # the DP size solve() took (auto resolved)


def run_batch(cfg: ProblemConfig, opts: SolverOptions, keys: Iterable[int],
              seed0: Optional[int] = None,
              on_row: Optional[Callable[[Row], None]] = None,
              max_ticks: Optional[int] = None) -> List[Row]:
    """Solve each key of `keys` with one solver object, resetting its
    table after each key, as scripts/stats_batch.py does.

    seed0 None keeps opts.seed (None: each key draws the time seed); an
    int gives key i the seed seed0 + i.  on_row(row) is called after
    each key.  max_ticks bounds each solve;
    a key it stops gets priv None (the JAX script's ABORT line)."""
    solver = KangarooSolver(cfg, opts)
    rows = []
    for i in keys:
        if seed0 is not None:
            opts.seed = seed0 + i
        t0 = time.time()
        res = solver.solve(i, max_ticks=max_ticks)
        wall = time.time() - t0
        st = solver.stats
        row = Row(i, None if res is None else res.private_key, st.count,
                  st.dead, st.dup, st.ticks, st.herd_time, st.time, wall,
                  st.expected_ops, solver.dp_size)
        rows.append(row)
        if on_row is not None:
            on_row(row)
        solver.hash_table.reset()
    return rows


def sqrt_range(cfg: ProblemConfig) -> float:
    """sqrt(N) of the config's range, N its number of keys."""
    return math.sqrt(cfg.range_end - cfg.range_start + 1)


def format_row(row: Row, sqrt_n: float) -> str:
    """A key's line: the JAX script's up to `dead=`, then the port's
    duplicate DPs among the dead, ticks, herd and walk seconds."""
    if row.priv is None:
        return f"key {row.key}: ABORT"
    c = row.count
    return (f"key {row.key:2d}: priv=0x{row.priv:X} ops=2^"
            f"{math.log2(max(c, 1)):.2f} ops/sqrtN={c / sqrt_n:.3f} "
            f"dead={row.dead} t={row.wall_s:.1f}s "
            f"rate={c / max(row.wall_s, 1e-9) / 1e6:.1f} MK/s "
            f"dup={row.dup} ticks={row.ticks} herd={row.herd_s:.2f}s "
            f"walk={row.walk_s:.2f}s")


def format_summary(rows: List[Row], cfg: ProblemConfig, opts: SolverOptions,
                   wall: float) -> str:
    """The JAX script's three summary lines over the solved keys, then
    the mean of ops/sqrt(N) with its standard error, and the dead lanes,
    ticks and herd and walk seconds per key."""
    done = [r for r in rows if r.priv is not None]
    if not done:
        return "\nSUMMARY: no key solved"
    n_range = cfg.range_end - cfg.range_start + 1
    sqrt_n = math.sqrt(n_range)
    n = len(done)
    counts = [r.count for r in done]
    deads = [r.dead for r in done]
    avg = sum(counts) / n
    m, se = mean_se([c / sqrt_n for c in counts])

    def per(f):
        return sum(f(r) for r in done) / n

    return "\n".join([
        f"\nSUMMARY: {n} keys, range 2^{math.log2(n_range):.0f}, "
        f"nk=2^{math.log2(opts.nb_kangaroo):.0f}, dp={done[0].dp}",
        f"avg ops = 2^{math.log2(avg):.3f} = {avg / sqrt_n:.3f}*sqrt(N) "
        f"(kangaroo model: 2.08*sqrt(N) incl. DP overhead "
        f"{done[0].expected / sqrt_n:.3f}*sqrt(N) at this dp/herd)",
        f"dead total = {sum(deads)} "
        f"({sum(deads) / max(sum(counts), 1) * 1e6:.2f} per Mops); "
        f"total wall {wall:.0f}s, avg solve rate "
        f"{sum(counts) / max(sum(r.wall_s for r in done), 1e-9) / 1e6:.1f}"
        f" MK/s",
        f"ops/sqrtN mean {m:.4f} +- {se:.4f} (standard error over {n} "
        f"keys)",
        f"per key: dead {per(lambda r: r.dead):.3f} (duplicate DPs "
        f"{per(lambda r: r.dup):.3f}), ticks "
        f"{per(lambda r: r.ticks):.2f}, herd {per(lambda r: r.herd_s):.3f}s, "
        f"walk {per(lambda r: r.walk_s):.3f}s",
    ])


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    sym, device = False, "cuda"
    pos = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-sym":
            sym = True
        elif a == "-device":
            if i + 1 >= len(args):
                raise SystemExit("-device needs a value (cuda or cpu)")
            i += 1
            device = args[i]
        elif a.startswith("-") and not a.lstrip("-").isdigit():
            raise SystemExit(f"unknown flag {a}\n{__doc__}")
        else:
            pos.append(a)
        i += 1
    if not pos:
        raise SystemExit(__doc__)
    nums = [int(x) for x in pos[1:]]
    nk_log2, dp, nbrun, kw, maxkeys, startkey = (
        nums + [16, -1, 0, 0, 0, 0][len(nums):])[:6]
    try:
        resolve_device(device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"stats_batch: {e}")
    cfg = parse_config_file(pos[0])
    opts = SolverOptions(nb_kangaroo=1 << nk_log2, dp_size=dp, nb_run=nbrun,
                         windows_per_tick=kw, symmetry=sym, device=device)
    n_keys = len(cfg.keys) if not maxkeys else min(maxkeys, len(cfg.keys))
    sqrt_n = sqrt_range(cfg)
    t0 = time.time()
    rows = run_batch(cfg, opts, range(startkey, n_keys),
                     on_row=lambda r: print(format_row(r, sqrt_n),
                                            flush=True))
    if rows:
        print(format_summary(rows, cfg, opts, time.time() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
