"""A long search on one key: the walk of a puzzle-range search.

Set-up builds one solver for a key drawn from the seed in the
configuration's range, makes its herd (`solve(max_ticks=0)`, whose
seconds are `herd_s_setup`), reads the sampled lanes' start, walks one
tick (the kernel's first launch) and then `warmup_ticks` ticks.  The
window is one more `solve()` of the same key, which continues the herd
and the table, for as many ticks as the warm-up's tick time gives for
`--seconds`.  `search_rate` is the jumps
of that call over its loop's seconds (`SolveStats.count` and `.time`
deltas: loop start to after its final drain and synchronise).

Traffic keys: `symmetry`, `warmup_ticks`, `sample_lanes` (lanes the
reference walks), `sample_records` (table records it checks).
"""

from __future__ import annotations

import math
import time

from portbench import compare
from portbench.harness import (Outcome, Run, device_ids, memory_peak,
                               record_resets, solver_options)
from portbench.reference import kangaroo as rk
from portbench.reference import secp256k1 as ec


def run(r: Run) -> Outcome:
    import torch
    from kangaroo_torch.core import curve
    from kangaroo_torch.core.config import ProblemConfig
    from kangaroo_torch.core.solver import KangarooSolver

    t_entry = time.time()
    cfg, tr = r.cell.config, r.cell.traffic
    start, end = int(cfg["range_start"], 16), int(cfg["range_end"], 16)
    sym = bool(tr["symmetry"])
    chips = r.cell.chips
    lanes = int(cfg["lanes_per_card"]) * chips
    key = start + int.from_bytes(r.rng("key").bytes(32), "little") % (
        end - start + 1)
    pub = ec.mul_g(key)
    herd_seed = r.seed32("herd")
    sample = compare.sample_lanes(r.rng("lanes"), lanes,
                                  int(tr["sample_lanes"]), chips)

    solver = KangarooSolver(ProblemConfig(start, end, [curve.PointA(*pub)]),
                            solver_options(r, lanes, sym, herd_seed))
    resets = record_resets(solver)
    t_solver = time.time()
    solver.solve(0, max_ticks=0)
    st = solver.stats
    herd_s = st.herd_time
    prog_start = compare.read_lanes(solver.last_state, sample)
    t_herd = time.time()
    # one tick to load the kernel, then the timed warm-up whose tick time
    # sets the window's ticks
    solver.solve(0, max_ticks=1)
    first_ticks = st.ticks
    t_before = st.time
    solver.solve(0, max_ticks=int(tr["warmup_ticks"]))
    warm_ticks = st.ticks
    tick_s = (st.time - t_before) / max(1, warm_ticks)
    ticks = max(1, math.ceil(r.seconds / tick_s))
    count0, time0, compact0 = st.count, st.time, len(st.compact_s)

    setup_s = time.time() - r.t_start
    r.tracer.start()
    solver.solve(0, max_ticks=ticks)
    r.tracer.stop()
    rate = (st.count - count0) / (st.time - time0)
    done = st.ticks

    mem = memory_peak(device_ids(r)) if r.cuda else 0
    prog_end = compare.read_lanes(solver.last_state, sample)
    nb_run, kw = solver.opts.nb_run, solver.windows_per_tick
    segments = [t * nb_run * kw for t in (first_ticks, warm_ticks, done)]
    program = {
        "herd_s_setup": herd_s, "ticks": done, "nb_run": nb_run,
        "windows_per_tick": kw, "dp_size": solver.dp_size,
        "lanes_per_launch": lanes // len(solver.shards),
        "compact_s": list(st.compact_s[compact0:]),
        "loop_s": st.time - time0,
    }
    table = compare.Table(solver.hash_table.export_arrays())
    info = {"key": hex(key), "herd_seed": herd_seed, "ticks": done,
            "tick_s_warmup": tick_s, "lost_dps": st.lost,
            "dead": st.dead, "table_records": len(table),
            "dp_size": solver.dp_size, "nb_run": nb_run,
            "windows_per_tick": kw, "slots": solver.n_slots,
            "setup_phases_s": {
                "start_to_driver": round(t_entry - r.t_start, 3),
                "inputs_and_solver": round(t_solver - t_entry, 3),
                "herd_call": round(t_herd - t_solver, 3),
                "warmup": round(r.t_start + setup_s - t_herd, 3)}}
    reset = set(resets)
    del solver
    if r.cuda:
        torch.cuda.empty_cache()

    # the reference, after the window
    search = rk.Search(start, end, pub, sym)
    jt = rk.jump_table(search.power, sym)
    tasks = [(search, herd_seed, lanes, list(c), segments, jt, info["dp_size"])
             for c in rk.chunks(sample, compare.pool_size(len(sample)))]
    ref_start, ref_end, dps = compare.merged(compare.herd_walks(tasks))
    kept = [j for j in sample if j not in reset]
    dp_checked, dp_missing = compare.missing_dps(search, dps, table,
                                                  skip=reset)
    rec_checked, rec_bad = compare.bad_records(
        search, table, r.rng("records"), int(tr["sample_records"]))
    info.update(lanes_checked=len(kept), dps_checked=dp_checked,
                records_checked=rec_checked,
                steps_per_lane=sum(segments))
    checks = [
        compare.Check("herd_mismatch",
                      compare.state_mismatch(ref_start, prog_start), 0),
        compare.Check("state_mismatch", compare.state_mismatch(
            {j: ref_end[j] for j in kept}, prog_end), 0),
        compare.Check("dp_missing", dp_missing, 0),
        compare.Check("bad_records", rec_bad, 0),
        compare.Check("ticks_short", ticks - done, 0),
        compare.Check("lanes_unchecked", len(sample) - len(kept),
                      len(sample) // 2),
    ]
    return Outcome({"search_rate": rate, "setup_s": setup_s}, checks,
                   attempted=ticks, failed=ticks - done,
                   memory_peak_bytes=mem, program=program, info=info)
