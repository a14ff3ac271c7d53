"""Keys of one range solved in turn by one solver, as the reference's
STATS loop does (Kangaroo.cpp:1010-1076).

The key set is fixed by the traffic file (`key_set` keys and their herd
seeds, drawn from `set_seed`); `--seed` orders it.  Set-up solves one
more key of the same range (all shapes warm).  The window solves the
keys in that order, each by one `solve()` with its own herd seed, in
whole passes over the set, and ends with the first pass that ends once
`--seconds` have passed: every run does the same work a pass.
`keys_per_s` is the keys solved over the span from the first key's
start to the last key's end, `key_s_p80` the 80th percentile (nearest
rank) of one key's `solve()` wall, herd included, over all keys of the
window; the 50th and 95th go on the run's `info` lines.

With `--trace 1` the first pass is not traced: the program's spans
(`herd_s_per_key`, `loop_ms_per_tick`) are read from it, free of the
profiler's cost to the host; the trace covers the passes after it (at
least one).

Traffic keys: `symmetry`, `key_set`, `set_seed`, `max_ticks` (a key
that takes more ticks stops unsolved), `sample_lanes` (lanes a key the
reference walks), `sample_records` (records of the last key's table).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from portbench import compare
from portbench.harness import (Outcome, Run, device_ids, memory_peak,
                               record_resets, solver_options)
from portbench.reference import kangaroo as rk
from portbench.reference import secp256k1 as ec


@dataclass
class Key:
    index: int
    priv: Optional[int]
    wall_s: float
    herd_s: float
    loop_s: float
    ticks: int
    state: tuple
    resets: List[int]


def key_set(start: int, end: int, count: int, seed: int):
    """`count` private keys in [start, end] and a herd seed for each, and
    one more pair for the warm-up (last)."""
    g = np.random.default_rng(seed)
    width = end - start + 1
    keys = [start + int.from_bytes(g.bytes(16), "little") % width
            for _ in range(count + 1)]
    seeds = [int(v) for v in g.integers(0, 2 ** 32, size=count + 1)]
    return keys, seeds


def percentile(values: List[float], q: float) -> float:
    """The q-quantile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def run(r: Run) -> Outcome:
    import torch
    from kangaroo_torch.core import curve
    from kangaroo_torch.core.config import ProblemConfig
    from kangaroo_torch.core.solver import KangarooSolver

    t_entry = time.time()
    cfg, tr = r.cell.config, r.cell.traffic
    start, end = int(cfg["range_start"], 16), int(cfg["range_end"], 16)
    sym = bool(tr["symmetry"])
    lanes = int(cfg["lanes_per_card"]) * r.cell.chips
    n_set = int(tr["key_set"])
    max_ticks = int(tr["max_ticks"])
    privs, seeds = key_set(start, end, n_set, int(tr["set_seed"]))
    pubs = [ec.mul_g(k) for k in privs]
    order = [int(v) for v in r.rng("order").permutation(n_set)]
    sample = compare.sample_lanes(r.rng("lanes"), lanes,
                                  int(tr["sample_lanes"]), r.cell.chips)

    pc = ProblemConfig(start, end, [curve.PointA(*p) for p in pubs])
    solver = KangarooSolver(pc, solver_options(r, lanes, sym, seeds[n_set]))
    resets = record_resets(solver)
    t_solver = time.time()
    solver.solve(n_set, max_ticks=max_ticks)

    setup_s = time.time() - r.t_start
    keys: List[Key] = []
    t_first = time.time()
    while True:
        i = order[len(keys) % n_set]
        solver.opts.seed = seeds[i]
        n0 = len(resets)
        t0 = time.time()
        res = solver.solve(i, max_ticks=max_ticks)
        t1 = time.time()
        st = solver.stats
        keys.append(Key(i, None if res is None else res.private_key,
                        t1 - t0, st.herd_time, st.time, st.ticks,
                        solver.last_state, resets[n0:]))
        if len(keys) % n_set:
            continue
        if len(keys) == n_set:
            r.tracer.start()
        if t1 - t_first >= r.seconds and (len(keys) > n_set
                                          or not r.tracer.enabled):
            break
    r.tracer.stop()
    span = t1 - t_first
    walls = [k.wall_s for k in keys]

    mem = memory_peak(device_ids(r)) if r.cuda else 0
    nb_run, kw = solver.opts.nb_run, solver.windows_per_tick
    dp = solver.dp_size
    prog_end = [compare.read_lanes(k.state, sample) for k in keys]
    last = keys[-1]
    table = compare.Table(solver.hash_table.export_arrays())
    for k in keys:
        k.state = ()
    del solver
    if r.cuda:
        torch.cuda.empty_cache()
    program = {"keys": [(k.herd_s, k.loop_s, k.ticks, k.wall_s)
                        for k in keys[:n_set]]}
    wrong = sum(1 for k in keys
                if k.priv is not None and k.priv != privs[k.index])
    unsolved = sum(1 for k in keys if k.priv is None)
    ticks_of = {}
    for k in keys:
        ticks_of.setdefault(k.index, set()).add(k.ticks)

    # the reference, after the window
    # one walk of the reference for each key and tick count: a key solved
    # again in a later pass repeats its walk
    jt = rk.jump_table(rk.Search(start, end, pubs[0], sym).power, sym)
    walks = sorted({(k.index, k.ticks) for k in keys})
    tasks = [(rk.Search(start, end, pubs[i], sym), seeds[i], lanes, sample,
              [t * nb_run * kw], jt, dp) for i, t in walks]
    results = dict(zip(walks, compare.herd_walks(tasks)))
    mismatch = unchecked = 0
    for k, prog in zip(keys, prog_end):
        ref_end = results[(k.index, k.ticks)][1]
        kept = [j for j in sample if j not in set(k.resets)]
        unchecked += len(sample) - len(kept)
        mismatch += compare.state_mismatch({j: ref_end[j] for j in kept}, prog)
    last_search = rk.Search(start, end, pubs[last.index], sym)
    # a solved key's last two ticks are not all drained
    dp_checked, dp_missing = compare.missing_dps(
        last_search, results[(last.index, last.ticks)][2], table,
        skip=last.resets,
        before_step=max(0, last.ticks - 2) * nb_run * kw)
    rec_checked, rec_bad = compare.bad_records(
        last_search, table, r.rng("records"), int(tr["sample_records"]))
    info = {"keys": len(keys), "passes": len(keys) // n_set,
            "ticks_per_key": sum(k.ticks for k in keys) / len(keys),
            "keys_whose_ticks_differ": sum(1 for v in ticks_of.values()
                                           if len(v) > 1),
            "window_s": span,
            "key_s_p50": percentile(walls, 0.5),
            "key_s_p95": percentile(walls, 0.95),
            "herd_s_mean": sum(k.herd_s for k in keys) / len(keys),
            "loop_ms_per_tick": 1e3 * sum(k.loop_s for k in keys)
            / max(1, sum(k.ticks for k in keys)),
            "reference_walks": len(walks),
            "dead": sum(len(k.resets) for k in keys),
            "lanes_checked": len(keys) * len(sample) - unchecked,
            "dps_checked": dp_checked, "records_checked": rec_checked,
            "dp_size": dp, "nb_run": nb_run, "windows_per_tick": kw,
            "setup_phases_s": {
                "start_to_driver": round(t_entry - r.t_start, 3),
                "inputs_and_solver": round(t_solver - t_entry, 3),
                "warmup_key": round(r.t_start + setup_s - t_solver, 3)}}
    checks = [
        compare.Check("wrong_keys", wrong, 0),
        compare.Check("unsolved_keys", unsolved, 0),
        compare.Check("state_mismatch", mismatch, 0),
        compare.Check("dp_missing", dp_missing, 0),
        compare.Check("bad_records", rec_bad, 0),
        compare.Check("lanes_unchecked", unchecked,
                      len(keys) * len(sample) // 2),
    ]
    return Outcome({"keys_per_s": len(keys) / span,
                    "key_s_p80": percentile(walls, 0.8), "setup_s": setup_s},
                   checks,
                   attempted=len(keys), failed=wrong + unsolved,
                   memory_peak_bytes=mem, program=program, info=info)
