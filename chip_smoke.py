#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (kangaroo_torch).

Drives the port's main paths on one CUDA card -- the solve, its work
files (checkpoint, resume, -wsplit merge, -winfo, -wcheck), the probe
entry points, -check, the network, the multi-device herd (two lane
shards, on two cards or side by side on one), fused launch windows, the
multi-process herd, the weak-scaling harness, STATS batches of many
keys and the graft entry (entry() and the sharded dry run) -- and
holds every kernel against its plain PyTorch version, phase by phase;
any fault raises and the exit code is non-zero.  Each phase prints its
seconds.
Run from the repository root:

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit;
  2. build: nvcc builds the walk kernels (plain and symmetry) and the
     probe kernels from csrc/, the two libraries at once (set-up time),
     with ptxas's register and spill report and a hash of each walk
     kernel's SASS (cuobjdump); for each walk kernel its registers,
     spills, resident blocks per SM (kt_walk_occupancy) and warps per
     scheduler at 2^22 lanes -- it fails unless both run without spill
     and fit a 2^22-lane grid in one wave; the herd kernel's library
     beside them, with its registers, local bytes and spills;
  3h. herd kernel vs its plain version (ops/herd_cuda.py): the start
     positions of a batch40 key's herd (8192 lanes x 5 windows) and of a
     puzzle85 search's (2^22 lanes x 11 windows), keyToSearch on wild
     lanes; one launch a call, bit-equal (tolerance 0), the kernel timed
     with CUDA events over HERD_REPS launches; the herd of phases 3-4s
     (2^22 lanes, plain and -sym) and the solves and STATS batches of
     phases 5, 5s and 11 then count their own herd-kernel launches and
     fail on none;
  3c. compaction kernels vs their plain version (ops/compact_cuda.py):
     a tick of a batch40 key (8192 lanes, 4 steps, dp 4, the solver's 6
     slots) and of a puzzle85 search (2^22 lanes, 1024 steps, dp 16, 4
     slots), DP counts drawn at the tick's rate; one kt_compact call a
     tick, queued with its copy to pinned memory, read after its event:
     lost and records bit-equal (tolerance 0), and once more through a
     block of 5 records, which spills; the queue, its kernels and copy
     timed with CUDA events over COMPACT_REPS ticks, beside the byte
     bound and the plain version's host-clocked time over as many
     calls after a warm one; the solves, work-file solves and
     resumes, clients, sharded, -nwin, weak-scaling and STATS phases
     then count their own compaction calls and fail unless there is
     one a shard and tick;
  3. plain kernel vs plain walk at the main path's shape: the kernel
     walks a 2^22-lane herd (512 blocks of 128 threads x 64 lanes) once
     with slot overflow (dp 6, 2 slots, 128 steps) and once as the
     solver runs it (dp 14, 6 slots, 128 steps); the plain walk runs the
     same window on 32 lanes of every block (2^14 lanes, corners of each
     block's thread x group grid included), and the kernel once more on
     those 2^14 lanes alone.
     The walk is exact per lane, so px, d, count and every DP slot must
     be bit-equal and py equal mod p (tolerance 0: integer arithmetic);
  4. full-width plain walk: 2^22 lanes x 1024 steps timed with CUDA
     events;
  3s. symmetry kernel vs plain symmetry walk, the same way, on a
     2^22-lane symmetry herd after one symmetry window (so that the
     class input holds both classes): dp 6, 2 slots, 128 steps, and
     dp 14, 6 slots, 128 steps; every output bit-equal, symclass and
     the canonical py included;
  4s. full-width symmetry walk, 2^22 x 1024, beside the plain one;
  5. end-to-end solve of fixtures/in56.txt at 2^22 lanes with the auto
     DP, through the plain kernel only (launch counts read around it);
  5s. end-to-end -sym solve of fixtures/in64.txt at 2^22 lanes with the
     auto DP, through the symmetry kernel only, then the plain in64
     solve with the same seed for its jump count;
  6. work files, plain: in64 at 2^22 lanes for 2 ticks with a save at
     every tick (-w, -wi 0, -ws); -winfo of the file; its loaded herd
     bit-equal to the snapshot the save took (px, canonical py, d);
     -wcheck on the card with 0 wrong over every DP of the file; the
     resume through the CLI's -i load path to the key, through the plain
     kernel only, its count continuing from the file's; the seconds of
     the save's stall and snapshot copy, write, load, resume and the
     -wcheck rate;
  6s. the same with -sym: a version-1 file, a resume without -sym
     refused with the JAX package's message, the -sym resume through the
     symmetry kernel only;
  6w. -wsplit: in64 plain for 3 ticks, a split file per tick, merged by
     merge_dir; -wcheck of the merged file on the card (0 wrong, its DP
     count the splits' less the merge's dead), a key the merge finds the
     fixture's;
  7. probes: each probe kernel (P1 field chains, P2 raw chains, P3 walk
     variants and base at each G, P4 inversion chains in the walk's
     layout and in the on-chip form) launched as its entry point
     launches it (inputs, lanes, geometry, rounds; P1's fe_inv and P2
     at fewer rounds) against its plain version on lanes of every block
     -- whole thread groups where a thread owns G lanes -- (tolerance
     0; f32 rtol 1e-5), the on-chip P4 rows also against the walk
     layout's kernel on the same lanes where the function is the same
     (cur, none; nodiv at G 32), P1's add-class chains (fe_sub,
     fe_add, fe_fold) also on 2^16 lanes of operands whose words are 0,
     1, 2^32 - 2 and 2^32 - 1 (every lane, 1 and 256 rounds), the P2
     chains after 256 and 293 iterations (whole unrolled trips, and
     trips and the loop after them), then the five probe entry points
     at their default shapes, launch counts read around them, and the
     SASS instructions per round of those three chains (all, and those
     of the ALU pipe) beside the slots their bound counts; each P2 row's
     share of its bound (of its latency floor for narrow1 and empty)
     and the highest IMAD rate of a P2 row against IMAD_PEAK, at
     the SM clock sampled while it ran;
  8. check: -check (run_self_check) on the card, launch counts read
     around it;
  9. network: the CLI's DP server (-s -d 14 -sp 0, in64) in a process
     of its own, and a CLI client (-c, 2^22 lanes) in this one, over
     loopback: the key the server prints is the fixture's, the client's
     walk ran through the plain kernel only; the wall, ticks, jumps, the
     loop's rate beside phase 5s's, the DPs sent and the solver
     thread's seconds in the sink per tick (median, max);
  9s. the same with -sym on both sides, through the symmetry kernel only;
  9w. -wss: a client at 2^22 lanes saves its herd through the server at
     every tick (-w -wi 0 -wss) and stops after 2 ticks; the herd that
     the server's HEADKS file rebuilds on the card is bit-equal to the
     snapshot sent (px, canonical py, d); a second client restores it
     from the server and runs to the key; the client's pack and send,
     the server's checksum and write, the load and the rebuild timed;
  9v. validated ingest: an in-process server (validate_points, on the
     card) takes 2^20 of the DPs sent in 9 and 9w from 4 connections at
     once, 1 % of them forged (x ^ 1): rejected must be exactly the
     forged count, the table must hold the rest; DPs/s;
  10a. sharded window: a 2^22-lane herd walks 256 steps at dp 14 with
     6 slots once as one launch and once as two 2^21-lane shards, each
     on its own stream (on cuda:0 and cuda:1 when the host has two
     cards, else both on cuda:0), plain and symmetry: every output
     bit-equal (tolerance 0: the same kernel on the same lanes);
  10b. sharded solve: in64 at 2^22 lanes in all on 2 shards, auto DP and
     phase 5s's seed: the key, and ticks, jumps, dead and lost equal to
     phase 5s's plain solve (the walk is the same); the wall, the loop's
     rate beside 5s's and each shard's compaction seconds per tick;
  10n. -nwin: in64 plain at 2^22 lanes with -nbrun 512 -nwin 2 to the
     key; its jumps must be ticks x 2 x 512 x 2^22; the rate;
  10m. multi-process: parallel/multihost.py with 2 processes over gloo,
     each walking 2^20 lanes of one herd for 256 steps through the
     kernel: the gathered walk bit-equal to one process's, the reduced
     DP hits equal to its;
  10w. weak scaling: parallel/weak_scaling.py's run_sizes at sizes 1 and
     2 (two cards, or both shards on cuda:0), first at its card defaults
     (2^22 lanes a shard, 64 steps, dp 16, the solver's slots), then at
     the solver's in64 tick (dp 14, 1024 steps, 6 slots): the random
     herd of the JAX script's seed; each size's first tick bit-equal to
     the plain walk on PER_BLOCK lanes of every block (tolerance 0, py
     mod p; at the in64 tick to the kernel on those lanes alone, which
     phase 3 holds to the plain walk); the drain (the solver's compaction, sharding.compact) under
     half the kernel time at every size; every row printed, with the
     caveat where the shards share a card, and 10b's compaction a tick
     beside it;
  11. (runs after 10w, before 7) STATS: keys 0..STATS_KEYS-1 of
     fixtures/in40_1000.txt solved as a batch through one solver object
     (kangaroo_torch.stats_batch run_batch, seed SEED + i for key i),
     plain in this process and -sym in a child process at the same
     time, at one 8192-lane block, dp 4, 4 steps a tick (a tick is sqrt(N)/32
     jumps; nk * 2^dp is the stock run's 2^10 * 2^7, so the model is
     the stock stream's, 2.160*sqrt(N), and 1.527*sqrt(N) with -sym):
     every key the stock binary's Priv (hw_evidence/stats_ref1000_r05.txt)
     and priv*G the key; each batch through its own kernel only; the
     plain mean of ops/sqrt(N) within 5 standard errors of its model
     plus the loop's lag (0 to 3 ticks), the -sym mean within 5 of the
     port's measured 1000-key -sym mean (SYM_MEAN_1000: the -sym walk
     misses its model) and below the plain mean on the same keys; then
     the kernel against the plain walk on key 0's herd at the batch's
     window (4 steps, dp 4, the solver's slots), 4 windows in a row,
     tolerance 0, in both modes; prints per mode the mean +- SE, dead,
     ticks, herd and walk seconds per key, the stock stream's mean and
     dead on the same keys, and the plain/-sym ratio beside sqrt(2);
  13. (runs after 8, before 12) the graft entry,
     kangaroo_torch.graft_entry: entry()'s window (4 steps, dp 16, 2
     slots) at 512 lanes against the plain walk on the CPU over every
     lane and at 2^22 lanes against the plain walk on PER_BLOCK lanes of
     every block, called twice on the same arguments with equal
     outputs; dryrun_multichip on 1 shard and on 2 shards of cuda:0 (64
     lanes a shard, 2 steps) against the plain walk on the CPU over the
     whole herd; python -m kangaroo_torch.graft_entry in a process of its
     own; tolerance 0, py mod p;
  12. the kernels line (launches by path, the new paths' included; the
     herd kernel's by the paths of 3h), the card line and the result
     line.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_FULL = 1 << 22
NB_FULL = 1024
SLOTS_FULL = 6
DP_FULL = 14
PER_BLOCK = 32  # lanes of each block the plain walk checks
RANGE_POWER = 64
SEED = 0x5EED
IN56_KEY = 0x9FD2E30C451A6B
IN64_KEY = 0xCAFEBABE12345678
NAMES = ("px", "py", "d", "count", "dpx", "dpd", "step")
# (dp, slots, steps, overflow expected) of the kernel-vs-plain windows.
# The plain walk takes 15-25 s per 256 steps on 2^14 lanes, by the
# host's speed; the windows are short (most lanes fill their 2 slots
# within 128 steps at dp 6) to keep the script well inside its time
# limit (phase 10w's plain checks came after them).
PLAIN_WINDOWS = ((6, 2, 128, True), (DP_FULL, SLOTS_FULL, 128, False))
SYM_WINDOWS = ((6, 2, 128, True), (DP_FULL, SLOTS_FULL, 128, False))
# probe comparisons (phase 7): lanes of each 128-lane block that the
# plain versions of P1's one-lane chains check; the rounds of the P1
# fe_inv and P2 comparison launches (the entry points run 16 and 2^17)
CMP_LANES_PER_BLOCK = 4
CMP_INV_ROUNDS = 1
CMP_INNER = 256
# iterations of the P2 comparisons: whole trips of every unroll (probes.cuh
# RAW_TRIP / ILP iterations a trip), and whole trips and 37 more, so that
# the loop after the trips runs on the card too
CMP_RAW_INNER = (CMP_INNER, CMP_INNER + 37)
# lanes of the add-class chains' run-word comparison (phase 7)
CMP_RUN_LANES = 1 << 16
# phase 11: keys of fixtures/in40_1000.txt per STATS batch, and the
# batch's herd (one walk-kernel block), DP and steps per tick
STATS_KEYS = 100
STATS_NK = 1 << 13
STATS_DP = 4
STATS_NBRUN = 4
# windows in a row of phase 11's kernel-vs-plain check on the batch's
# first herd
STATS_CMP_WINDOWS = 4
# the port's -sym mean ops/sqrt(N) and its standard error over all 1000
# keys at phase 11's options (python -m kangaroo_torch.stats_batch
# fixtures/in40_1000.txt 13 4 4 1 -sym, time seeds, NVIDIA H100 80GB
# HBM3 at 700 W; PERF.md section 6): the -sym walk misses its model
# (1.527), so the batch's -sym mean is held to this measurement
SYM_MEAN_1000 = (2.0756, 0.0330)
# phase 3h: (lanes, byte windows, range bits) of a batch40 key's herd and
# of a puzzle85 search's, and the timed launches of each
HERD_SHAPES = ((STATS_NK, 5, 40), (N_FULL, 11, 85))
HERD_REPS = 20
# the herd kernel's launches by path (_herd_count), for the kernels line
HERD_LAUNCHES = {}
# phase 3c: (lanes, slots, steps, dp) of a batch40 tick and of a
# puzzle85 search's, and the timed ticks of each
COMPACT_SHAPES = ((STATS_NK, 6, STATS_NBRUN, STATS_DP), (N_FULL, 4, 1024, 16))
COMPACT_REPS = 50
# the compaction's kt_compact calls by path (_compact_count), for the
# kernels line
COMPACT_LAUNCHES = {}
# weak_scaling.run_sizes's timed drains a size; each shard compacts once
# more, untimed, before them
WEAK_REPS = 3


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {name}; {torch.cuda.device_count()} device(s); "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return name, smi


def phase_build():
    """Build both libraries at once; print the walk kernels' and the
    probe kernels' ptxas reports and each walk kernel's SASS hash."""
    from concurrent.futures import ThreadPoolExecutor

    from kangaroo_torch.ops import (compact_cuda, herd_cuda, jump_cuda,
                                    probe_cuda)
    from kangaroo_torch.utils import sass
    from kangaroo_torch.utils.build import BUILD_DIR

    t = time.time()
    with ThreadPoolExecutor(4) as ex:
        walk_f, probe_f, herd_f, compact_f = (
            ex.submit(jump_cuda.build), ex.submit(probe_cuda.build),
            ex.submit(herd_cuda.build), ex.submit(compact_cuda.build))
        lib, probe_lib = walk_f.result(), probe_f.result()
        herd_lib, compact_lib = herd_f.result(), compact_f.result()
    log = (BUILD_DIR / f"{lib.name}.log").read_text()
    kinds = {"ILb0E": "plain:", "ILb1E": "symmetry:"}
    ptx = [next((v for k, v in kinds.items() if k in ln), ln.strip())
           if "entry function" in ln else ln.strip()
           for ln in log.splitlines()
           if "entry function" in ln or "registers" in ln or "spill" in ln]
    print(f"[2 build] {time.time() - t:.1f}s {lib.name} and "
          f"{probe_lib.name}: " + " | ".join(ptx), flush=True)
    funcs = sass.sass_functions(lib)
    names = sass.demangle(sorted(funcs))
    for mangled in sorted(funcs):
        print(f"[2 build] SASS {names[mangled]}: {len(funcs[mangled])} "
              f"instructions, sha256 {sass.sass_hash(funcs[mangled])}",
              flush=True)
    walk_rep = sass.ptxas_report(log)
    for label, tag in (("plain", "ILb0E"), ("symmetry", "ILb1E")):
        occ = jump_cuda.occupancy(N_FULL, label == "symmetry")
        r = next(v for k, v in walk_rep.items() if tag in k)
        spill = r.get("spill_stores", 0) + r.get("spill_loads", 0)
        print(f"[2 build] walk kernel, {label}: {occ['regs']} registers, "
              f"spill stores/loads {r.get('spill_stores')}/"
              f"{r.get('spill_loads')} B, {occ['local_bytes']} B local "
              f"(prefix products {jump_cuda.GROUP} x 32 B), "
              f"{occ['blocks_per_sm']} resident blocks/SM "
              f"(kt_walk_occupancy); 2^22 lanes = {occ['blocks']} "
              f"blocks of {jump_cuda.THREADS} threads x {jump_cuda.GROUP} "
              f"lanes on {occ['sms']} SMs: "
              f"{'one wave' if occ['one_wave'] else 'more than one wave'}, "
              f"{occ['warps_per_scheduler']:.2f} warps per scheduler",
              flush=True)
        if spill or not occ["one_wave"]:
            raise SystemExit(f"walk kernel ({label}) spills or does not fit "
                             f"2^22 lanes in one wave")
    (r,) = sass.ptxas_report(
        (BUILD_DIR / f"{herd_lib.name}.log").read_text()).values()
    print(f"[2 build] herd kernel: {r.get('regs')} registers, spill "
          f"stores/loads {r.get('spill_stores')}/{r.get('spill_loads')} B, "
          f"{r.get('stack')} B stack (prefix products up to "
          f"{herd_cuda.MAX_GROUP - 1} x 32 B)", flush=True)
    rep = sass.ptxas_report(
        (BUILD_DIR / f"{compact_lib.name}.log").read_text())
    cnames = sass.demangle(sorted(rep))
    print("[2 build] compaction kernels: " + "; ".join(
        f"{cnames[k].split('(')[0].replace('void ', '')}: {r.get('regs')} "
        f"registers, spill {r.get('spill_stores')}/{r.get('spill_loads')} "
        f"B, smem {r.get('smem')} B" for k, r in sorted(rep.items())),
        flush=True)
    rep = sass.ptxas_report((BUILD_DIR / f"{probe_lib.name}.log").read_text())
    pnames = sass.demangle(sorted(rep))
    spills = [pnames[k] for k, r in rep.items()
              if r.get("spill_stores") or r.get("spill_loads")]
    print(f"[2 build] {probe_lib.name}: {len(rep)} kernels; "
          + "; ".join(f"{pnames[k].split('(')[0].replace('void ', '')}: "
                      f"{r.get('regs')} regs, stack {r.get('stack')} B, "
                      f"smem {r.get('smem')} B, spill "
                      f"{r.get('spill_stores')}/{r.get('spill_loads')}"
                      for k, r in sorted(rep.items(),
                                         key=lambda kv: pnames[kv[0]]))
          + f"; kernels that spill: {spills or 'none'}", flush=True)


def _herd(n, dev, sym=False):
    """A herd of n lanes on dev, made by one herd-kernel launch; returns
    ((px, py, d), seconds)."""
    from kangaroo_torch.core import curve, herd
    from kangaroo_torch.ops import herd_cuda
    from kangaroo_torch.utils.rng import MT19937

    wd2 = ((1 << RANGE_POWER) - 1) >> 1
    torch.cuda.synchronize()
    herd_cuda.LAUNCHES = 0
    t = time.time()
    px, py, d = herd.create_herd(n, RANGE_POWER, wd2,
                                 curve.mul(0xDEADBEEF12345), 0,
                                 MT19937(SEED), device=dev, symmetry=sym)
    torch.cuda.synchronize()
    s = time.time() - t
    _herd_count(f"herd {n} lanes{' -sym' if sym else ''}", exact=1)
    return (px, py, d), s


def _herd_count(path, least=1, exact=None):
    """The herd kernel's launches since herd_cuda.LAUNCHES was last set
    to 0, kept under `path` for the kernels line and printed; fails
    below `least` (a path that took the plain k*G on the card shows 0)
    or, where given, unless they are `exact`."""
    from kangaroo_torch.ops import herd_cuda

    k = HERD_LAUNCHES[path] = herd_cuda.LAUNCHES
    print(f"[herd launches] {path}: {k}", flush=True)
    if k < least or (exact is not None and k != exact):
        raise SystemExit(f"{path}: {k} herd-kernel launches, "
                         f"{exact if exact is not None else f'>= {least}'} "
                         f"wanted")
    return k


def _compact_count(path, exact):
    """The compaction's kt_compact calls since _reset_counts, kept under
    `path` for the kernels line and printed; fails unless they are
    `exact` (one a shard and tick: a path that compacted with torch ops
    on the card shows 0)."""
    from kangaroo_torch.ops import compact_cuda

    k = COMPACT_LAUNCHES[path] = compact_cuda.LAUNCHES
    print(f"[compact launches] {path}: {k}", flush=True)
    if k != exact or k == 0:
        raise SystemExit(f"{path}: {k} compaction-kernel calls, {exact} "
                         f"(ticks x shards) wanted")
    return k


def _herd_inputs(n, windows, bits, dev):
    """mag, neg, wild of n lanes: |d| uniform below 2^bits (bits <= 8
    windows), neg on random lanes, wild on odd lanes."""
    rs = np.random.RandomState(SEED + n)
    by = rs.randint(0, 256, (2 * ((windows + 1) // 2), n))
    by[windows:] = 0
    by[(bits - 1) // 8] &= (1 << (bits - 8 * ((bits - 1) // 8))) - 1
    mag = np.zeros((16, n), dtype=np.int32)
    mag[:by.shape[0] // 2] = by[0::2] | (by[1::2] << 8)
    neg = rs.random_sample(n) < 0.5
    wild = np.arange(n) % 2 == 1
    return [torch.from_numpy(a).to(dev) for a in (mag, neg, wild)]


def phase_herd(dev):
    """kt_herd_kernel against its plain version at HERD_SHAPES; returns
    the kernels line's entry."""
    from kangaroo_torch.core import curve
    from kangaroo_torch.ops import herd_cuda

    key = curve.mul(0xDEADBEEF12345)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst = [], 0
    start = herd_cuda.LAUNCHES
    for n, windows, bits in HERD_SHAPES:
        mag, neg, wild = _herd_inputs(n, windows, bits, dev)
        launches = herd_cuda.LAUNCHES
        got = herd_cuda.positions(mag, neg, wild, key, windows)
        torch.cuda.synchronize()
        if herd_cuda.LAUNCHES != launches + 1:
            raise SystemExit("herd kernel: not one launch a call")
        t = time.time()
        want = herd_cuda.positions_plain(mag, neg, wild, key, windows)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t) * 1e3
        err = max(_max_err(a, b) for a, b in zip(got, want))
        worst = max(worst, err)
        if err:
            raise SystemExit(f"herd kernel differs from its plain version "
                             f"at {n} lanes x {windows} windows: {err}")
        del want
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(HERD_REPS):
            herd_cuda.positions(mag, neg, wild, key, windows)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / HERD_REPS
        adds = herd_cuda.adds_needed(mag.cpu().numpy(), wild.cpu().numpy(),
                                     windows)
        bound = herd_cuda.bound_ms(n, adds)
        g = herd_cuda.group_for(n, sms)
        print(f"[3h herd] {n} lanes x {windows} windows + key: kernel "
              f"{ms:.4f} ms (G {g}, {-(-n // (herd_cuda.THREADS * g))} "
              f"blocks), bound {bound:.4f} ms ({adds} adds, "
              f"{100 * bound / ms:.1f} %), plain {plain_ms:.1f} ms; 1 launch "
              f"a call, bit-equal", flush=True)
        rows.append((n, windows, ms, bound, plain_ms))
    launches = herd_cuda.LAUNCHES - start
    HERD_LAUNCHES["3h kernel check"] = launches
    if launches != len(HERD_SHAPES) * (HERD_REPS + 1):
        raise SystemExit(f"3h: {launches} herd-kernel launches for "
                         f"{len(HERD_SHAPES) * (HERD_REPS + 1)} calls")
    torch.cuda.empty_cache()
    (n0, w0, ms0, b0, p0), (n1, w1, ms1, b1, p1) = rows
    return {
        "name": "positions (herd k*G)",
        "route": "cuda",
        "source": "kangaroo_torch/csrc/herd_kernel.cu",
        "replaces": None,
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms1, "plain_ms": p1, "bound_ms": b1, "bound_by": "operations",
        "library_ms": None,
        "shape": f"{n1} lanes x {w1} windows + key",
        "ms_batch_key": ms0, "plain_ms_batch_key": p0,
        "bound_ms_batch_key": b0,
        "shape_batch_key": f"{n0} lanes x {w0} windows + key",
    }


def _compact_windows(n, slots, steps, dp, dev):
    """One window of n lanes: DP counts drawn from Poisson(steps / 2^dp),
    random 16-bit slot limbs and steps."""
    rs = np.random.RandomState(SEED + n)
    arrays = (rs.poisson(steps / float(1 << dp), n).astype(np.int32),
              rs.randint(0, 1 << 16, (slots, 10, n)).astype(np.int32),
              rs.randint(0, 1 << 16, (slots, 8, n)).astype(np.int32),
              rs.randint(0, steps, (slots, n)).astype(np.int32))
    return [tuple(torch.from_numpy(a).to(dev) for a in arrays)]


def phase_compact(dev):
    """kt_compact_kernel (with its count and scan launches and the copy)
    against its plain version at COMPACT_SHAPES; returns the kernels
    line's entry."""
    from kangaroo_torch.ops import compact_cuda

    rows, start = [], compact_cuda.LAUNCHES
    for n, slots, steps, dp in COMPACT_SHAPES:
        wins = _compact_windows(n, slots, steps, dp, dev)
        # the first call also loads the process's first torch ops
        lost, want = compact_cuda.compact_plain(wins, slots, steps, 0)
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(COMPACT_REPS):
            compact_cuda.compact_plain(wins, slots, steps, 0)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t) * 1e3 / COMPACT_REPS
        cap = compact_cuda.capacity(n, steps, 1, dp, slots)
        blocks = compact_cuda.Blocks(dev, n, slots, 1, cap)
        for b in (blocks, compact_cuda.Blocks(dev, n, slots, 1, 5)):
            q = b.queue(wins, slots, steps, 0)
            torch.cuda.current_stream(dev).record_event().synchronize()
            got_lost, got = q.read()
            if got_lost != lost or not np.array_equal(got, want):
                raise SystemExit(f"compaction kernel differs from its plain "
                                 f"version at {n} lanes, capacity {b.cap}")
            if q.spilled != (len(want) > b.cap):
                raise SystemExit(f"compaction at {n} lanes: spilled "
                                 f"{q.spilled} with {len(want)} records and "
                                 f"capacity {b.cap}")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(COMPACT_REPS):
            blocks.queue(wins, slots, steps, 0)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / COMPACT_REPS
        t = time.time()
        for _ in range(COMPACT_REPS):
            q = blocks.queue(wins, slots, steps, 0)
            torch.cuda.current_stream(dev).record_event().synchronize()
            q.read()
        host_ms = (time.time() - t) * 1e3 / COMPACT_REPS
        bound = compact_cuda.bound_ms(n, 1, len(want))
        print(f"[3c compact] {n} lanes x {slots} slots, {steps} steps at dp "
              f"{dp}: {len(want)} records, {lost} lost, capacity {cap}; "
              f"kernels and copy {ms:.4f} ms, queue to read on the host "
              f"{host_ms:.4f} ms, bound {bound:.4f} ms (bytes, "
              f"{100 * bound / ms:.1f} %), plain {plain_ms:.2f} ms; "
              f"bit-equal, the spill too", flush=True)
        rows.append((n, slots, ms, host_ms, bound, plain_ms, len(want)))
        del wins, blocks
    launches = compact_cuda.LAUNCHES - start
    if launches != len(COMPACT_SHAPES) * (2 + 2 * COMPACT_REPS):
        raise SystemExit(f"3c: {launches} compaction calls for "
                         f"{len(COMPACT_SHAPES) * (2 + 2 * COMPACT_REPS)}")
    torch.cuda.empty_cache()
    (n0, s0, ms0, h0, b0, p0, m0), (n1, s1, ms1, h1, b1, p1, m1) = rows
    return {
        "name": "compact (a tick's DP compaction)",
        "route": "cuda",
        "source": "kangaroo_torch/csrc/compact_kernel.cu",
        "replaces": None,
        "launches": launches,
        "max_abs_err": 0,
        "ms": ms1, "host_ms": h1, "plain_ms": p1, "bound_ms": b1,
        "bound_by": "bytes", "library_ms": None,
        "shape": f"{n1} lanes x {s1} slots, {m1} records",
        "ms_batch_tick": ms0, "host_ms_batch_tick": h0,
        "plain_ms_batch_tick": p0, "bound_ms_batch_tick": b0,
        "shape_batch_tick": f"{n0} lanes x {s0} slots, {m0} records",
    }


def _tables(dev, sym=False):
    from kangaroo_torch.core.jumptable import create_jump_table

    return [torch.from_numpy(a.astype("int32")).to(dev)
            for a in create_jump_table(RANGE_POWER, sym).as_arrays()]


def _walk(fn, state, tabs, masks, nb_run, slots):
    """fn (the kernel's wrapper or the plain walk) on state (px, py, d
    and, in symmetry mode, symclass)."""
    sym = {"symmetry": True, "symclass": state[3]} if len(state) > 3 else {}
    return fn(*state[:3], *tabs, masks, nb_run=nb_run, slots=slots, **sym)


def _subset(dev, n=N_FULL):
    """PER_BLOCK lanes of every block of the kernel over n lanes: the
    four corners of the block's thread x group grid and random others."""
    from kangaroo_torch.ops import jump_cuda

    q, t = jump_cuda.LANE_QUANTUM, jump_cuda.THREADS
    rs = np.random.RandomState(SEED)
    corners = [0, t - 1, q - t, q - 1]
    idx = [b * q + np.concatenate(
               [corners, rs.choice(q, PER_BLOCK - len(corners),
                                   replace=False)])
           for b in range(n // q)]
    return torch.from_numpy(np.concatenate(idx)).to(dev)


def _errors(got, want, sym):
    from kangaroo_torch.ops import field

    errs = {}
    for name, a, b in zip(NAMES + ("symclass",), got, want):
        if name == "py" and not sym:  # relaxed in the plain walk
            a, b = field.canonicalize(a), field.canonicalize(b)
        errs[name] = int((a.long() - b.long()).abs().max())
    return errs


def phase_compare(state, dev, windows):
    """Kernel vs plain on identical inputs at the main path's shape, in
    symmetry mode when state carries a symclass; returns (max_abs_err,
    plain ms, kernel ms on the plain's lanes, the number of those lanes,
    steps) of the last window, the solver's configuration."""
    from kangaroo_torch.ops import jump_cuda, jump_ref
    from kangaroo_torch.profile_walk import cuda_ms

    sym = len(state) > 3
    tag = "3s compare, symmetry" if sym else "3 compare"
    tabs = _tables(dev, sym)
    idx = _subset(dev)
    worst, res = 0, None
    for dp, slots, nb_run, overflow in windows:
        masks = jump_ref.dp_limb_masks(dp, dev)
        kin = [t.clone() for t in state]
        sin = [t[..., idx].contiguous() for t in state]
        pin = [t.clone() for t in sin]
        k, k_ms = cuda_ms(lambda: _walk(jump_cuda.jump_steps_with_dp, kin,
                                        tabs, masks, nb_run, slots))
        k_sub = [t[..., idx] for t in k]
        full_count = k[3]
        flips = int((k[7] != state[3]).sum()) if sym else 0
        del k, kin
        s, s_ms = cuda_ms(lambda: _walk(jump_cuda.jump_steps_with_dp, sin,
                                        tabs, masks, nb_run, slots))
        p, p_ms = cuda_ms(lambda: _walk(jump_ref.jump_steps_with_dp, pin,
                                        tabs, masks, nb_run, slots))
        errs = _errors(k_sub, p, sym)
        errs_one = _errors(s, p, sym)
        err = max(max(errs.values()), max(errs_one.values()))
        print(f"[{tag}] dp {dp}, {slots} slots, {nb_run} steps: kernel "
              f"at {N_FULL} lanes {k_ms:.1f} ms, {int(full_count.sum())} "
              f"DPs, {int((full_count > slots).sum())} lanes over their "
              + (f"slots, {flips} lanes changed class; " if sym
                 else "slots; ")
              + f"plain on {idx.numel()} of them ({PER_BLOCK} per "
              f"block) {p_ms:.1f} ms, {int(p[3].sum())} DPs; max |kernel - "
              f"plain| {errs}; kernel on those lanes alone {s_ms:.1f} ms, "
              f"max |kernel - plain| {errs_one}", flush=True)
        if err != 0:
            raise SystemExit(f"kernel disagrees with the plain walk: "
                             f"{errs} {errs_one}")
        if (int(p[3].sum()) == 0
                or bool((full_count > slots).any()) != overflow
                or bool((p[3] > slots).any()) != overflow
                or (sym and not 0 < flips < N_FULL)):
            raise SystemExit("compare: window did not give the DP pattern "
                             "it was chosen for")
        worst = max(worst, err)
        res = (worst, p_ms, s_ms, idx.numel(), nb_run)
    return res


def phase_full(state, herd_s, dev, plain_ms=None):
    """Time the kernel at the main path's shape (the symmetry kernel
    when state carries a symclass); returns (ms, bound_ms, bound_by)."""
    from kangaroo_torch.ops import jump_cuda, jump_ref
    from kangaroo_torch.profile_walk import cuda_ms

    sym = len(state) > 3
    tabs = _tables(dev, sym)
    masks = jump_ref.dp_limb_masks(DP_FULL, dev)

    def launch():
        return _walk(jump_cuda.jump_steps_with_dp, state, tabs, masks,
                     NB_FULL, SLOTS_FULL)

    launch()  # warm-up
    _, ms = cuda_ms(launch, reps=3)
    jumps = N_FULL * NB_FULL
    bound, by = jump_cuda.bound_ms(N_FULL, NB_FULL, SLOTS_FULL, sym)
    state_b = jump_cuda.STATE_BYTES_PER_JUMP + (
        jump_cuda.SYM_STATE_BYTES if sym else 0)
    print(f"[{'4s full width, symmetry' if sym else '4 full width'}] "
          f"{N_FULL} lanes x {NB_FULL} steps: kernel "
          f"{ms:.1f} ms/launch, {jumps / ms * 1e3 / 1e9:.3f} G jumps/s"
          + (f" (plain kernel, phase 4: {plain_ms:.1f} ms/launch, "
             f"{jumps / plain_ms * 1e3 / 1e9:.3f} G jumps/s)" if sym
             else "")
          + f"; bound {bound:.1f} ms ({by}: "
          f"{jump_cuda.imad_per_jump(N_FULL):.1f} IMAD/jump, one inversion "
          f"a step for the herd, at {jump_cuda.IMAD_PEAK:.4g}/s, derived "
          f"peak); this design's {jump_cuda.imad_per_jump():.1f} IMAD/jump "
          f"at G {jump_cuda.GROUP} and traffic floor "
          f"{jump_cuda.design_traffic_ms(N_FULL, NB_FULL, sym):.1f} ms "
          f"({state_b} B per lane and step at "
          f"{jump_cuda.HBM_RATE:.3g} B/s); herd creation {herd_s:.1f} s; "
          f"no single PyTorch call computes this walk (library_ms null)",
          flush=True)
    return ms, bound, by


def phase_solve(fixture, key, sym=False, tag="5 solve"):
    """A main path: a fixture solved through the solver on the card, the
    plain one through the plain kernel only, the -sym one through the
    symmetry kernel only; returns (launches of that kernel, stats)."""
    from pathlib import Path

    from kangaroo_torch.core.config import parse_config_file
    from kangaroo_torch.core.solver import KangarooSolver, SolverOptions
    from kangaroo_torch.ops import jump_cuda, jump_ref

    cfg = parse_config_file(
        str(Path(__file__).resolve().parent / "fixtures" / fixture))
    opts = SolverOptions(nb_kangaroo=N_FULL, nb_run=0, seed=SEED,
                         device="cuda", quiet=True, symmetry=sym)
    _reset_counts()
    t = time.time()
    solver = KangarooSolver(cfg, opts)
    res = solver.solve(0)
    torch.cuda.synchronize()
    wall = time.time() - t
    plain_k, sym_k = jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES
    plain_calls = jump_ref.CALLS
    st = solver.stats
    print(f"[{tag}] {fixture}{' -sym' if sym else ''} at "
          f"{opts.nb_kangaroo} lanes, dp {solver.dp_size}, nb_run "
          f"{opts.nb_run}, slots {solver.n_slots}: key "
          f"{hex(res.private_key) if res else None}"
          f"{' [' + str(res.variant) + res.sign_info + ']' if res else ''};"
          f" wall {wall:.2f} s (herd {st.herd_time:.2f} s, walk "
          f"{st.time:.2f} s, {st.ticks} ticks, 2^"
          f"{math.log2(max(st.count, 1)):.2f} jumps against 2^"
          f"{math.log2(st.expected_ops):.2f} expected, "
          f"{st.count / st.time / 1e9:.3f} G jumps/s, dead {st.dead}, "
          f"lost {st.lost}); plain kernel launches {plain_k}, symmetry "
          f"kernel launches {sym_k}, plain walk calls {plain_calls}",
          flush=True)
    if res is None or res.private_key != key:
        raise SystemExit(f"{fixture} solve did not give the known key")
    launches, other = (sym_k, plain_k) if sym else (plain_k, sym_k)
    if launches == 0 or other != 0 or plain_calls != 0:
        raise SystemExit("the solve did not run through its walk kernel")
    # the herd, then one launch a tick with dead lanes
    _herd_count(f"{tag} {fixture}")
    _compact_count(f"{tag} {fixture}", st.ticks * len(solver.shards))
    return launches, st


def _reset_counts():
    from kangaroo_torch.ops import compact_cuda, herd_cuda, jump_cuda, jump_ref

    compact_cuda.LAUNCHES = 0
    herd_cuda.LAUNCHES = 0
    jump_cuda.LAUNCHES = 0
    jump_cuda.SYM_LAUNCHES = 0
    jump_ref.CALLS = 0


def _read_counts(sym, what):
    """The walk launches since _reset_counts; fails unless they all went
    through the path's own kernel."""
    from kangaroo_torch.ops import jump_cuda, jump_ref

    plain_k, sym_k = jump_cuda.LAUNCHES, jump_cuda.SYM_LAUNCHES
    launches, other = (sym_k, plain_k) if sym else (plain_k, sym_k)
    if launches == 0 or other != 0 or jump_ref.CALLS != 0:
        raise SystemExit(f"{what} did not run through its walk kernel "
                         f"only: plain {plain_k}, symmetry {sym_k}, plain "
                         f"walk calls {jump_ref.CALLS}")
    return launches


def phase_work(sym, fixture="in64.txt", key=IN64_KEY, n=N_FULL,
               device="cuda"):
    """6 / 6s: checkpoint and resume.  A solve of 2 ticks saves its herd
    and table every tick (save_period 0, -ws); the file's herd must be
    bit-equal to the snapshot the last save took, -wcheck on the card
    must re-derive every DP of it, and the CLI's -i load path
    (KangarooSolver.from_work) must resume it to the key through the
    walk kernel only, the count continuing from the file's.  -sym: the
    file has version 1 and a resume without -sym is refused with the
    JAX package's message.  The plain phase first runs the same 2 ticks
    without saves, for the saves' cost to the loop."""
    import contextlib
    import io
    import os
    import tempfile
    from pathlib import Path

    from kangaroo_torch import cli
    from kangaroo_torch.core.check import check_work_file
    from kangaroo_torch.core.config import parse_config_file
    from kangaroo_torch.core.solver import KangarooSolver, SolverOptions
    from kangaroo_torch.io import backup
    from kangaroo_torch.utils.packing import canon_mod_p

    tag = "6s work files, -sym" if sym else "6 work files"
    fx = str(Path(__file__).resolve().parent / "fixtures" / fixture)
    run = dict(nb_kangaroo=n, nb_run=0, device=device, quiet=True,
               symmetry=sym)
    ref = ""
    if not sym:
        r = KangarooSolver(parse_config_file(fx),
                           SolverOptions(seed=SEED, **run))
        r.solve(0, max_ticks=2)
        ref = (f" against {r.stats.time:.4f} s for the same 2 ticks "
               f"without saves")
        del r
    with tempfile.TemporaryDirectory() as td:
        wf = os.path.join(td, "w.work")
        _reset_counts()
        # -wt 60 s: the second tick's save waits for the first's write
        # (seconds at 2^22 lanes) instead of being skipped
        s = KangarooSolver(parse_config_file(fx), SolverOptions(
            seed=SEED, work_file=wf, save_period=0, save_kangaroo=True,
            save_timeout=60.0, **run))
        t = time.time()
        res = s.solve(0, max_ticks=2)
        wall = time.time() - t
        launches_save = _read_counts(sym, "the saving solve")
        st = s.stats
        _compact_count(f"{tag} saving solve", st.ticks * len(s.shards))
        if res is not None or st.saves != st.ticks:
            raise SystemExit(f"{tag}: the 2-tick solve solved, or did not "
                             f"save at each tick")
        print(f"[{tag}] {fixture} at {n} lanes, dp {s.dp_size}, nb_run "
              f"{s.opts.nb_run}: {st.ticks} ticks with a save each, wall "
              f"{wall:.2f} s (herd {st.herd_time:.2f} s); walk "
              f"{st.time:.4f} s, of it {st.save_wait:.4f} s waiting for "
              f"the first save's write and {st.save_stall:.4f} s starting "
              f"the saves on the solver thread (the first allocates the "
              f"pinned buffers); walk less the wait "
              f"{st.time - st.save_wait:.4f} s{ref}; launches "
              f"{launches_save}", flush=True)
        # the last save's own buffers: the snapshot that went to the file
        saved = [b.numpy().astype(np.uint32) for b in s._snap]
        info = backup.work_info(wf)
        print(f"[{tag}] -winfo: " + "; ".join(info.splitlines()), flush=True)
        t = time.time()
        lw = backup.load_work(wf)
        load_s = time.time() - t
        want_version = "Version   : 1" if sym else "Version   : 0"
        if lw.symmetry != sym or want_version not in info:
            raise SystemExit(f"{tag}: the file's version is wrong")
        for name, got, want in zip(("px", "py", "d"), lw.kangaroos,
                                   (saved[0], canon_mod_p(saved[1]),
                                    saved[2])):
            if not np.array_equal(got, want):
                raise SystemExit(f"{tag}: loaded {name} differs from the "
                                 f"saved snapshot")
        # one more snapshot, timed alone: the copy a save puts on the
        # walk's stream before the next launch
        t = time.perf_counter()
        snap, evs = s._snapshot([s.last_state])
        for ev in evs:
            ev.synchronize()
        copy_s = time.perf_counter() - t
        snap = [b.numpy() for b in snap]
        wf2 = os.path.join(td, "w2.work")
        t = time.time()
        backup.save_work(wf2, s, *snap, st.count, st.time,
                         save_kangaroo=True)
        write_s = time.time() - t
        size = os.path.getsize(wf2)
        os.remove(wf2)
        t = time.time()
        rep = check_work_file(wf, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        check_s = time.time() - t
        n_dp = lw.hash_table.n_items()
        print(f"[{tag}] herd snapshot copy {copy_s:.4f} s "
              f"({40 * n * 4 / 2 ** 20:.0f} MiB of limbs to pinned host "
              f"memory on the walk's stream); write {write_s:.2f} s "
              f"({size} B, {n_dp} DPs, {lw.nb_kangaroo} kangaroos); load "
              f"{load_s:.2f} s; -wcheck {rep.n_items} DPs, {rep.n_wrong} "
              f"wrong in {check_s:.2f} s = {rep.n_items / check_s:.0f} "
              f"DPs/s", flush=True)
        if rep.n_wrong or rep.n_items != n_dp or n_dp == 0:
            raise SystemExit(f"{tag}: -wcheck failed")
        if sym:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["-nk", str(n), "-device", device, "-i", wf])
            want = (f"{wf}: work file was saved with -sym; rerun with -sym "
                    f"to resume it")
            if rc != -1 or want not in out.getvalue():
                raise SystemExit(f"{tag}: a resume without -sym was not "
                                 f"refused: {rc} {out.getvalue()!r}")
            print(f"[{tag}] a resume without -sym exits {rc}: "
                  f"{want!r}", flush=True)
        _reset_counts()
        t = time.time()
        s2 = KangarooSolver.from_work(lw, SolverOptions(seed=SEED + 1,
                                                        **run))
        res = s2.solve(0)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t
        launches = _read_counts(sym, "the resumed solve")
        st2 = s2.stats
        _compact_count(f"{tag} resume", st2.ticks * len(s2.shards))
        print(f"[{tag}] resumed with -i: key "
              f"{hex(res.private_key) if res else None}; wall {wall:.2f} s "
              f"(restore {st2.herd_time:.2f} s, {st2.ticks} ticks); count "
              f"2^{math.log2(lw.count):.2f} in the file -> 2^"
              f"{math.log2(st2.count):.2f}; launches {launches}", flush=True)
        if res is None or res.private_key != key:
            raise SystemExit(f"{tag}: the resume did not give the key")
        if st2.count != lw.count + st2.ticks * n * s2.opts.nb_run:
            raise SystemExit(f"{tag}: the count did not continue")
    return launches_save, launches


def phase_wsplit(fixture="in64.txt", key=IN64_KEY, n=N_FULL,
                 device="cuda"):
    """6w: -wsplit.  3 ticks of the plain solve, a split file per save;
    merge_dir folds them into one file, which -wcheck re-derives on the
    card with 0 wrong and whose DP count is the splits' less the dead
    the merge reports.  A key the merge finds must be the fixture's (the
    merge then writes no file, and each split is checked instead)."""
    import glob
    import os
    import tempfile
    from pathlib import Path

    from kangaroo_torch.core.check import check_work_file
    from kangaroo_torch.core.config import parse_config_file
    from kangaroo_torch.core.solver import KangarooSolver, SolverOptions
    from kangaroo_torch.io import backup, merge

    fx = str(Path(__file__).resolve().parent / "fixtures" / fixture)
    with tempfile.TemporaryDirectory() as td:
        wdir = os.path.join(td, "splits")
        os.mkdir(wdir)
        _reset_counts()
        s = KangarooSolver(parse_config_file(fx), SolverOptions(
            nb_kangaroo=n, nb_run=0, seed=SEED, device=device, quiet=True,
            work_file=os.path.join(wdir, "w.work"), save_period=0,
            split_work_file=True))
        t = time.time()
        res = s.solve(0, max_ticks=3)
        wall = time.time() - t
        launches = _read_counts(False, "the -wsplit solve")
        splits = sorted(glob.glob(os.path.join(wdir, "w.work_*")))
        counts = [backup.load_work(p, load_kangaroos=False)
                  .hash_table.n_items() for p in splits]
        print(f"[6w -wsplit] {fixture} at {n} lanes: {s.stats.ticks} ticks "
              f"in {wall:.2f} s, key {hex(res.private_key) if res else None};"
              f" {len(splits)} split files of {counts} DPs; launches "
              f"{launches}", flush=True)
        if len(splits) < 2:
            raise SystemExit("6w: fewer than 2 split files")
        if res is not None and res.private_key != key:
            raise SystemExit("6w: the solve gave a wrong key")
        dest = os.path.join(td, "merged.work")
        t = time.time()
        _, mres, dead = merge.merge_dir(wdir, dest)
        merge_s = time.time() - t
        if mres is not None:
            if mres.private_key != key:
                raise SystemExit("6w: the merge gave a wrong key")
            checked = [check_work_file(p, device=device) for p in splits]
            print(f"[6w -wsplit] merge_dir in {merge_s:.2f} s found the key "
                  f"{hex(mres.private_key)} (no merged file); -wcheck of "
                  f"each split: {[(r.n_items, r.n_wrong) for r in checked]}",
                  flush=True)
            if any(r.n_wrong for r in checked):
                raise SystemExit("6w: -wcheck failed on a split file")
            return launches
        n_dp = backup.load_work(dest, load_kangaroos=False) \
            .hash_table.n_items()
        t = time.time()
        rep = check_work_file(dest, device=device)
        check_s = time.time() - t
        print(f"[6w -wsplit] merge_dir in {merge_s:.2f} s: {n_dp} DPs, dead "
              f"{dead} (splits {sum(counts)}); -wcheck {rep.n_items} DPs, "
              f"{rep.n_wrong} wrong in {check_s:.2f} s", flush=True)
        if rep.n_wrong or rep.n_items != n_dp or n_dp != sum(counts) - dead:
            raise SystemExit("6w: the merged file is wrong")
    return launches


@contextlib.contextmanager
def _cli_server(args, cwd, timeout=300):
    """The port's CLI server (-s -sp 0 args) in a process of its own, in
    cwd; yields (port, its output lines so far), and stops the process
    on the way out."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "kangaroo_torch.cli", "-s", "-sp", "0",
         *args], cwd=cwd, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(
        target=lambda: lines.extend(ln.rstrip("\n") for ln in proc.stdout),
        daemon=True)
    reader.start()
    try:
        deadline = time.time() + 120
        port = None
        while port is None and time.time() < deadline:
            hit = [ln for ln in list(lines) if "listening on port" in ln]
            if hit:
                port = int(hit[0].split("listening on port")[1].split()[0])
            elif proc.poll() is not None:
                break
            else:
                time.sleep(0.05)
        if port is None:
            raise SystemExit(f"the CLI server did not start: {lines}")
        yield port, lines
        proc.wait(timeout=timeout)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _server_key(lines):
    keys = [ln.split("Priv:")[1].strip() for ln in lines if "Priv:" in ln]
    return int(keys[-1], 16) if keys else None


@contextlib.contextmanager
def _client_reports(sent=None):
    """Collect the report of every run_client call (the CLI's too) and,
    when `sent` is a list, the payload of every SENDDP delivered."""
    from kangaroo_torch.net import client

    reports = []
    real_run = client.run_client
    real_send = client.ServerConnection.send_dps_raw

    def run(*a, **kw):
        reports.append(real_run(*a, **kw))
        return reports[-1]

    def send(self, payload, nb, *a, **kw):
        status = real_send(self, payload, nb, *a, **kw)
        sent.append(payload)
        return status

    client.run_client = run
    if sent is not None:
        client.ServerConnection.send_dps_raw = send
    try:
        yield reports
    finally:
        client.run_client = real_run
        client.ServerConnection.send_dps_raw = real_send


def phase_net(sym, standalone, sent, fixture="in64.txt", key=IN64_KEY):
    """9 / 9s: the CLI server in its own process, a CLI client here (so
    that the launch counts see its walk), to the key; returns the walk
    kernel's launches in the client."""
    import tempfile
    from pathlib import Path

    from kangaroo_torch import cli

    tag = "9s network, -sym" if sym else "9 network"
    fx = str(Path(__file__).resolve().parent / "fixtures" / fixture)
    flag = ["-sym"] if sym else []
    with tempfile.TemporaryDirectory() as td, \
            _cli_server(["-d", str(DP_FULL), *flag, fx], td) as (port, out):
        t = time.time()
        _reset_counts()
        with _client_reports(None if sym else sent) as reports:
            rc = cli.main(["-c", "127.0.0.1", "-sp", str(port), "-nk",
                           str(N_FULL), *flag])
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = _read_counts(sym, tag)
    rep = reports[0]
    st = rep.solver.stats
    _compact_count(tag, st.ticks * len(rep.solver.shards))
    stalls = np.array(rep.sink_stalls) * 1e3
    got = _server_key(out)
    print(f"[{tag}] {fixture} at {N_FULL} lanes, server dp {DP_FULL}, "
          f"client exit {rc}: server key {hex(got) if got else None}; "
          f"client wall {wall:.2f} s (herd {st.herd_time:.2f} s, walk "
          f"{st.time:.2f} s, {st.ticks} ticks, 2^"
          f"{math.log2(max(st.count, 1)):.2f} jumps, loop "
          f"{st.count / st.time / 1e9:.3f} G jumps/s against the standalone "
          f"{standalone.count / standalone.time / 1e9:.3f} of phase 5s); "
          f"{rep.dps_sent} DPs sent in {rep.sends} sends; sink stall per "
          f"tick median {np.median(stalls):.2f} ms, max {stalls.max():.2f} "
          f"ms over {len(stalls)} ticks; server heard the end: "
          f"{rep.ended}; launches {launches}", flush=True)
    if rc != 0 or got != key or not rep.ended:
        raise SystemExit(f"{tag}: the server did not find the key "
                         f"{hex(key)}: {out[-5:]}")
    return launches


def phase_wss(sent, fixture="in64.txt", key=IN64_KEY):
    """9w: -wss save at every tick for 2 ticks, the server's file
    rebuilt on the card bit-equal to the snapshot sent, then a client
    restored from the server to the key."""
    import tempfile
    from pathlib import Path

    from kangaroo_torch.core.solver import SolverOptions
    from kangaroo_torch.io import backup
    from kangaroo_torch.net.client import ServerConnection, run_client
    from kangaroo_torch.utils.packing import canon_mod_p, le_bytes_to_limbs

    tag = "9w -wss"
    fx = str(Path(__file__).resolve().parent / "fixtures" / fixture)
    with tempfile.TemporaryDirectory() as td, \
            _cli_server(["-d", str(DP_FULL), fx], td) as (port, out), \
            _client_reports(sent):
        wf = os.path.join(td, "k.srv")
        run = dict(nb_kangaroo=N_FULL, nb_run=0, device="cuda", quiet=True,
                   work_file=wf)
        _reset_counts()
        t = time.time()
        rep = run_client("127.0.0.1", port, SolverOptions(
            seed=SEED, save_period=0, **run), save_kangaroo_server=True,
            max_ticks=2, quiet=True)
        torch.cuda.synchronize()
        wall = time.time() - t
        launches_save = _read_counts(False, "the -wss saving client")
        st = rep.solver.stats
        if rep.ended or len(rep.wss) != 2:
            raise SystemExit(f"{tag}: the 2-tick client ended the search "
                             f"or did not save at each tick")
        sent_herd = [b.numpy().copy() for b in rep.solver._snap]
        deadline = time.time() + 30
        while (sum("Kangaroo backup" in ln for ln in list(out)) < 2
               and time.time() < deadline):
            time.sleep(0.05)
        srv_lines = [ln.strip() for ln in out if "Kangaroo backup" in ln]
        print(f"[{tag}] client at {N_FULL} lanes, dp {rep.solver.dp_size}: "
              f"{st.ticks} ticks with a -wss save each in {wall:.2f} s "
              f"(herd {st.herd_time:.2f} s, walk {st.time:.2f} s, solver "
              f"thread in the saves {st.save_stall:.3f} s); pack, send "
              f"(s): {[(round(a, 4), round(b, 4)) for a, b in rep.wss]}; "
              f"server: {srv_lines}; launches {launches_save}", flush=True)
        if len(srv_lines) != 2:
            raise SystemExit(f"{tag}: the server did not keep 2 backups")
        conn = ServerConnection("127.0.0.1", port, timeout=30.0)
        conn.connect()
        t = time.time()
        raw = conn.load_kangaroos_via_server(wf)
        load_s = time.time() - t
        conn.close()
        t = time.time()
        herd = backup.rebuild_from_d128(
            le_bytes_to_limbs(np.frombuffer(raw, np.uint8).reshape(-1, 16),
                              8),
            rep.solver.range_start, rep.solver.range_end,
            rep.solver.key_to_search, device="cuda")
        torch.cuda.synchronize()
        rebuild_s = time.time() - t
        for name, got, want in zip(
                ("px", "py", "d"),
                (herd[0], canon_mod_p(herd[1]), herd[2]),
                (sent_herd[0], canon_mod_p(sent_herd[1]), sent_herd[2])):
            if not np.array_equal(got.astype(np.int64),
                                  want.astype(np.int64)):
                raise SystemExit(f"{tag}: rebuilt {name} differs from the "
                                 f"snapshot sent")
        print(f"[{tag}] load {load_s:.3f} s ({len(raw)} B over loopback), "
              f"rebuild on the card {rebuild_s:.2f} s: px, canonical py and "
              f"d bit-equal to the snapshot sent", flush=True)
        _reset_counts()
        t = time.time()
        rep2 = run_client("127.0.0.1", port, SolverOptions(
            seed=SEED + 1, save_period=3600, **run),
            save_kangaroo_server=True, quiet=True)
        torch.cuda.synchronize()
        wall2 = time.time() - t
        launches_resume = _read_counts(False, "the -wss restored client")
        st2 = rep2.solver.stats
    got = _server_key(out)
    print(f"[{tag}] restored client: {rep2.restored} kangaroos from the "
          f"server; wall {wall2:.2f} s (restore {st2.herd_time:.2f} s, "
          f"{st2.ticks} ticks), {rep2.dps_sent} DPs sent; server key "
          f"{hex(got) if got else None}; launches {launches_resume}",
          flush=True)
    if rep2.restored != N_FULL or got != key or not rep2.ended:
        raise SystemExit(f"{tag}: the restored client did not reach the key")
    return launches_save, launches_resume


def phase_ingest(sent, n=1 << 20, conns=4):
    """9v: validated ingest on the card.  2^20 plain in64 DPs from the
    clients of 9 and 9w, without the wild records whose x a tame record
    also has (the pairs that solve the key, which would end the
    search), 1 % forged (x ^ 1), go to an in-process server over `conns`
    connections at once."""
    from pathlib import Path

    from kangaroo_torch.core.config import parse_config_file
    from kangaroo_torch.net.client import ServerConnection
    from kangaroo_torch.net.server import DPServer

    tag = "9v validated ingest"
    arr = np.frombuffer(b"".join(sent), np.uint8).reshape(-1, 40)
    keys = np.zeros((len(arr), 3), dtype=np.uint64)
    keys[:, 0] = arr[:, 4:8].copy().view("<u4").ravel()
    keys[:, 1:] = arr[:, 8:24].copy().view("<u8")
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.ravel()
    wild = ((arr[:, 39] >> 6) & 1) == 1
    has_tame = np.zeros(inv.max() + 1, dtype=bool)
    has_tame[inv[~wild]] = True
    solving = wild & has_tame[inv]
    arr = arr[~solving][:n].copy()
    if len(arr) < n:
        raise SystemExit(f"{tag}: only {len(arr)} DPs were sent")
    bad = np.zeros(n, dtype=bool)
    bad[np.random.RandomState(SEED).choice(n, n // 100, replace=False)] = True
    arr[bad, 8] ^= 1
    srv = DPServer(parse_config_file(
        str(Path(__file__).resolve().parent / "fixtures" / "in64.txt")),
        DP_FULL, port=0, validate_points=True, device="cuda")
    srv.process_period = 0.05
    st = threading.Thread(target=srv.run, daemon=True,
                          kwargs={"max_seconds": 600, "quiet": True})
    st.start()
    deadline = time.time() + 30
    while srv.port == 0 and time.time() < deadline:
        time.sleep(0.02)
    errors = []

    def client(part):
        try:
            conn = ServerConnection("127.0.0.1", srv.port, timeout=60.0)
            conn.connect()
            for off in range(0, len(part), 1 << 16):
                blk = part[off:off + (1 << 16)]
                conn.send_dps_raw(blk.tobytes(), len(blk))
            conn.close()
        except Exception as e:  # reported by the phase
            errors.append(e)

    t = time.time()
    ths = [threading.Thread(target=client, args=(p,), daemon=True)
           for p in np.array_split(arr, conns)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=300)
    deadline = time.time() + 300
    while (srv.hash_table.n_items() + srv.dead + srv.rejected < n
           and time.time() < deadline):
        time.sleep(0.01)
    dt = time.time() - t
    srv.end_of_search = True
    st.join(timeout=60)
    kept = srv.hash_table.n_items() + srv.dead
    print(f"[{tag}] {n} DPs ({int(solving.sum())} solving wild DPs left "
          f"out) over {conns} connections in {dt:.2f} s = {n / dt:.0f} "
          f"DPs/s; rejected {srv.rejected} of {int(bad.sum())} forged; "
          f"table {srv.hash_table.n_items()}, dead {srv.dead}; client "
          f"errors {errors}", flush=True)
    if (errors or srv.rejected != int(bad.sum()) or kept != n - int(bad.sum())
            or srv.result is not None or any(th.is_alive() for th in ths)
            or st.is_alive()):
        raise SystemExit(f"{tag}: the validated ingest is wrong")
    return n / dt


def _sym_state(dev):
    """A 2^22-lane symmetry herd after one symmetry window of the
    kernel, so that its classes hold both values."""
    from kangaroo_torch.ops import jump_cuda, jump_ref

    (px, py, d), herd_s = _herd(N_FULL, dev, sym=True)
    state = (px, py, d, torch.zeros(N_FULL, dtype=torch.int32, device=dev))
    out = _walk(jump_cuda.jump_steps_with_dp, state, _tables(dev, True),
                jump_ref.dp_limb_masks(DP_FULL, dev), 64, SLOTS_FULL)
    state = (out[0], out[1], out[2], out[7])
    ones = int(state[3].sum())
    if not 0 < ones < N_FULL:
        raise SystemExit("symmetry window left every lane in one class")
    return state, herd_s


def _entry(label, launches, cmp, ms, bound, by, by_path):
    err, p_ms, k_small_ms, n_plain, steps = cmp
    return {
        "name": f"jump_steps_with_dp (walk, {label})",
        "route": "cuda",
        "source": "kangaroo_torch/csrc/jump_kernel.cu",
        "replaces": "kangaroo_tpu/ops/jump_pallas.py:471",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "shape": f"{N_FULL} lanes x {NB_FULL} steps",
        "plain_shape": f"{n_plain} lanes x {steps} steps",
        "ms_at_plain_shape": k_small_ms,
        "launches_by_path": by_path,
    }


PROBE_SOURCE = "kangaroo_torch/csrc/probe_kernels.cu"
PROBE_REPLACES = {"pkbench": "scripts/pkbench.py:62",
                  "probe_ops": "scripts/probe_ops.py:49",
                  "layout_probe": "scripts/layout_probe.py:109",
                  "pkdelta": "scripts/pkdelta.py:213",
                  "pkinv": "scripts/pkinv.py:129"}


def _max_err(got, want, canon=False):
    """max |got - want| (0 where equal, infinities included); field
    values compared canonical."""
    from kangaroo_torch.ops import field

    if canon:
        got, want = field.canonicalize(got), field.canonicalize(want)
    d = (got.double() - want.double()).abs()
    d[got == want] = 0
    return float(d.max())


def _lane_sample(blocks, size, per_block, rs):
    """per_block lanes of each of `blocks` blocks of `size` one-lane
    threads: the first and the last lane of every block and random
    others (one lane per block: random, the first block's first and the
    last block's last)."""
    pick = rs.randint(0, size, (blocks, per_block))
    if per_block > 1:
        pick[:, 0], pick[:, -1] = 0, size - 1
    else:
        pick[0, 0], pick[-1, 0] = 0, size - 1
    return (np.arange(blocks)[:, None] * size + pick).reshape(-1)


def _group_sample(blocks, group, rs, want=()):
    """Every lane of some threads of each of `blocks` blocks of THREADS
    threads x `group` lanes (thread t of block b owns lanes
    b*THREADS*group + g*THREADS + t): one thread per block (THREADS in
    all where there are fewer blocks), thread 0 of the first block and
    the last thread of the last among them, elsewhere the thread of a
    lane in `want` where the block has one, else random threads.
    Ordered as the plain versions group lanes: sampled thread s =
    q*THREADS + u owns columns q*THREADS*group + g*THREADS + u."""
    from kangaroo_torch.ops import probe_cuda

    t = probe_cuda.THREADS
    per = max(1, t // blocks)
    if blocks * per % t:
        raise ValueError(f"{blocks} blocks do not give whole sets of {t} "
                         f"threads")
    pick = np.stack([rs.permutation(t)[:per] for _ in range(blocks)])
    for lane in want:
        b, u = lane // (t * group), lane % t
        if u not in pick[b]:
            pick[b, 0] = u
    for b, u in ((0, 0), (blocks - 1, t - 1)):
        if u not in pick[b]:
            pick[b, -1 if u else 0] = u
    lanes = (np.arange(blocks)[:, None, None] * t * group
             + np.arange(group)[None, None, :] * t + pick[:, :, None])
    return lanes.reshape(-1, t, group).transpose(0, 2, 1).reshape(-1)


def _chip_sets(w, group, rs):
    """The lane sets (probe_ref.lane_sets) of one thread of each block of
    THREADS threads x `group` lanes on w lanes: thread 0 of the first
    block, the last thread of the last, random threads elsewhere;
    (blocks, group)."""
    from kangaroo_torch.ops import probe_cuda, probe_ref

    t = probe_cuda.THREADS
    blocks = w // (t * group)
    pick = rs.randint(0, t, blocks)
    pick[0], pick[-1] = 0, t - 1
    return probe_ref.lane_sets(w, group).numpy()[
        np.arange(blocks) * t + pick]


def _run_words(n, seed, dev):
    """(16, n) int32 limbs of field values whose 32-bit words are drawn
    from 0, 1, 2^32 - 2 and 2^32 - 1."""
    words = np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.int64)[
        np.random.RandomState(seed).randint(0, 4, (8, n))]
    limbs = np.empty((16, n), dtype=np.int64)
    limbs[0::2], limbs[1::2] = words & 0xFFFF, words >> 16
    return torch.from_numpy(limbs.astype(np.int32)).to(dev)


def phase_probe_compare(dev):
    """Each probe kernel against its plain version on identical inputs.
    The kernel runs as its entry point runs it: the entry point's inputs,
    lane or element count, geometry, rounds, DP size and slots -- only
    P1's fe_inv (plain: a Python pow per lane) and the P2 chains (plain:
    one launch per iteration) at fewer rounds.  The plain version runs on
    lanes of every block of that launch: P1's one-lane chains a few
    lanes of each block; P1's step, P3 and P4, whose threads own G lanes
    each, every lane of one thread per block (P3: a thread with a DP in
    this run where the block has one); P2 every element.  The add-class
    chains also run on operands of run words (_run_words), every lane.
    Returns {kernel
    key: (max_abs_err, plain ms, kernel launch, plain shape)}.  Launches
    made here are not the probes' main path."""
    from kangaroo_torch.ops import jump_ref, probe_cuda, probe_ref
    from kangaroo_torch.probes import (common, layout_probe, pkbench,
                                       pkdelta, pkinv, probe_ops)
    from kangaroo_torch.profile_walk import cuda_ms

    rs = np.random.RandomState(SEED)
    thr, grp = probe_cuda.THREADS, probe_cuda.GROUP
    res = {}

    def record(key, got, want, p_ms, shape, p_shape, canon=False,
               rtol=0.0):
        err = _max_err(got, want, canon)
        if rtol:
            torch.testing.assert_close(got, want, rtol=rtol, atol=0)
        elif err:
            raise SystemExit(f"{key} at {shape} disagrees with its plain "
                             f"version: max |kernel - plain| {err}")
        old = res.get(key)  # another launch of the same kernel
        res[key] = ((max(err, old[0]), old[1], f"{old[2]}; {shape}",
                     f"{old[3]}; {p_shape}") if old
                    else (err, p_ms, shape, p_shape))

    t0 = time.time()
    n = 1 << pkbench.LANES_LOG2
    a, b, tbl, jx, jy = pkbench.inputs(n, dev)
    per_lane = torch.from_numpy(
        _lane_sample(n // thr, thr, CMP_LANES_PER_BLOCK, rs)).to(dev)
    one_lane = torch.from_numpy(_lane_sample(n // thr, thr, 1, rs)).to(dev)
    steps_idx = torch.from_numpy(
        _group_sample(n // (thr * grp), grp, rs)).to(dev)
    walk_blocks = common.walk_blocks()
    for op in probe_ref.FIELD_OPS:
        tabs = pkbench.tables(op, tbl, jx, jy)
        rounds = CMP_INV_ROUNDS if op == "inv" else pkbench.ROUNDS[op]
        idx = {"inv": one_lane, "step": steps_idx}.get(op, per_lane)
        p_shape = (f"{idx.numel()} lanes, "
                   + ("every lane of one thread per block" if op == "step"
                      else f"{idx.numel() * thr // n} of each block")
                   + f", x {rounds} rounds")
        p, p_ms = cuda_ms(lambda: probe_ref.field_chain(
            op, a[:, idx], b[:, idx], rounds, *tabs))
        for smem in ((0, common.hold_to("field_chain", op, 0, walk_blocks))
                     if op in ("mul", "sqr") else (0,)):
            k = probe_cuda.field_chain(op, a.clone(), b, rounds, *tabs,
                                       smem=smem)
            record(probe_cuda.kernel_key("field_chain", op), k[:, idx], p,
                   p_ms, f"{n} lanes x {rounds} rounds"
                   + (f", {smem} B dynamic shared memory" if smem else ""),
                   p_shape, canon=op not in ("gather", "step"))
            del k
    # the add-class chains on operands whose words are 0, 1, 2^32 - 2
    # and 2^32 - 1, so that carries and borrows run through every word
    # and fe_sub meets b - a > p: every lane, after 1 and 256 rounds
    ra, rb = (_run_words(CMP_RUN_LANES, s, dev) for s in (1, 2))
    for op in ("sub", "add", "fold"):
        for rounds in (1, pkbench.ROUNDS[op]):
            p, p_ms = cuda_ms(lambda: probe_ref.field_chain(op, ra, rb,
                                                            rounds))
            shape = f"{CMP_RUN_LANES} lanes of run words x {rounds} rounds"
            record(probe_cuda.kernel_key("field_chain", op),
                   probe_cuda.field_chain(op, ra.clone(), rb, rounds), p,
                   p_ms, shape, shape, canon=True)
    del ra, rb
    # fe_inv's latency row: one block of 128 lanes, every lane
    r = pkbench.ROUNDS["inv"]
    x1, b1 = (t[:, :pkbench.INV_LANES].contiguous() for t in (a, b))
    p, p_ms = cuda_ms(lambda: probe_ref.field_chain("inv", x1, b1, r))
    record(probe_cuda.kernel_key("field_chain", "inv"),
           probe_cuda.field_chain("inv", x1.clone(), b1, r), p, p_ms,
           f"{pkbench.INV_LANES} lanes x {r} rounds",
           f"{pkbench.INV_LANES} lanes x {r} rounds", canon=True)
    del a, b, per_lane, one_lane, steps_idx
    t1 = time.time()

    def raw(op, x, ilp, smem=0):
        f32 = op in probe_ref.F32_OPS
        for inner in CMP_RAW_INNER:
            p, p_ms = cuda_ms(lambda: probe_ref.raw_chain(op, x, inner))
            k = probe_cuda.raw_chain(op, x.clone(), inner, ilp, smem)
            shape = (f"{x.numel()} elements x {inner} iterations, ILP {ilp}"
                     + (f", {smem} B dynamic shared memory" if smem else ""))
            record(probe_cuda.kernel_key("raw_chain", op, ilp), k, p, p_ms,
                   shape, f"{x.numel()} elements x {inner} iterations",
                   rtol=1e-5 if f32 else 0.0)

    for op in probe_ops.OPS:
        raw(op, probe_ops.inputs(op, probe_ops.ELEMS, dev), probe_ops.ILP)
    a = layout_probe.inputs(layout_probe.W, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for v, (ilp, _, op) in layout_probe.VARIANTS.items():
        smem = (common.hold_to("raw_chain", op, ilp, walk_blocks)
                if v == "wide_walk" else 0)
        raw(op, a[:layout_probe.elements(v, layout_probe.W, sms)].clone(),
            ilp, smem)
    del a
    t2 = time.time()

    n = 1 << pkdelta.HERD_LOG2
    state, tabs = pkdelta.inputs(n, dev)
    masks = jump_ref.dp_limb_masks(pkdelta.DP_SIZE, dev)
    for v, g in ((v, g) for v in probe_ref.DELTA_VARIANTS
                 for g in probe_cuda.DELTA_GROUPS[v]):
        shape = (f"{n} lanes x {pkdelta.NB_RUN} steps, dp {pkdelta.DP_SIZE}, "
                 f"{pkdelta.SLOTS} slots, G {g}")
        k = probe_cuda.delta_walk(v, *[t.clone() for t in state], *tabs,
                                  masks, pkdelta.NB_RUN, pkdelta.SLOTS, g)
        hits = torch.nonzero(k[3]).flatten().cpu().numpy()
        idx = torch.from_numpy(
            _group_sample(n // (thr * g), g, rs, hits)).to(dev)
        sub = [t[:, idx] for t in state]
        p, p_ms = cuda_ms(lambda: probe_ref.delta_walk(
            v, *sub, *tabs, masks, pkdelta.NB_RUN, pkdelta.SLOTS))
        errs = [_max_err(x[..., idx], y, canon=i == 1)
                for i, (x, y) in enumerate(zip(k, p))]
        if max(errs) or (int(p[3].sum()) == 0) != (v == "no_dp"):
            raise SystemExit(f"walk variant {v} at G {g} disagrees with its "
                             f"plain version: {errs}, {int(p[3].sum())} DPs "
                             f"on the plain lanes")
        res[probe_cuda.kernel_key("delta", v, g)] = (
            max(errs), p_ms, shape,
            f"{idx.numel()} lanes (every lane of one thread per block; "
            f"{len(hits)} lanes of the launch hit DPs, "
            f"{int((p[3] > 0).sum())} of these)")
        del k
    del state
    t3 = time.time()

    threads = (1 << pkinv.W_LOG2) // grp
    for name in pkinv.DEFAULT:
        form, var, g = pkinv.parse(name)
        if form == "walk":
            x = pkinv.inputs(threads * g, dev)
            idx = torch.from_numpy(
                _group_sample(threads // thr, g, rs)).to(dev)
            p, p_ms = cuda_ms(lambda: probe_ref.inv_chain(
                var, x[:, idx], pkinv.ITERS, g))
            k = probe_cuda.inv_chain(var, x.clone(), pkinv.ITERS, g)
            record(probe_cuda.kernel_key("inv_chain", var, g), k[:, idx], p,
                   p_ms,
                   f"{x.shape[1]} lanes x {pkinv.ITERS} iterations, G {g}",
                   f"{idx.numel()} lanes (every lane of one thread per "
                   f"block)")
            del k, x
            continue
        # the on-chip form at its entry point's lanes (one wave); also
        # against the walk layout's kernel on the same lanes where the
        # function is the same: cur and none at any G, nodiv at G 32
        w = pkinv.chip_lanes(var, g, dev)
        x = pkinv.inputs(w, dev)
        sets = _chip_sets(w, g, rs)
        idx = torch.from_numpy(sets.reshape(-1)).to(dev)
        local = torch.arange(idx.numel()).reshape(sets.shape)
        p, p_ms = cuda_ms(lambda: probe_ref.inv_chain(
            var, x[:, idx], pkinv.ITERS, sets=local))
        k = probe_cuda.inv_chip(var, x.clone(), pkinv.ITERS, g)
        key = probe_cuda.kernel_key("inv_chip", var, g)
        shape = f"{w} lanes x {pkinv.ITERS} iterations, G {g}"
        record(key, k[:, idx], p, p_ms, shape,
               f"{idx.numel()} lanes (every lane of one thread per block)")
        walk_g = {"cur": 32, "none": grp}.get(var, 32 if g == 32 else 0)
        if walk_g:
            m = w - w % (thr * walk_g)
            wk = probe_cuda.inv_chain(var, x[:, :m].contiguous(),
                                      pkinv.ITERS, walk_g)
            record(key, k[:, :m], wk, None, shape,
                   f"the walk layout's {var} at G {walk_g} on lanes "
                   f"0..{m - 1}")
            del wk
        del k, x
    torch.cuda.synchronize()
    print(f"[7 probes, compare] {len(res)} probe kernels bit-equal to their "
          f"plain versions at their entry points' launches (f32 rows within "
          f"rtol 1e-5: max |kernel - plain| "
          f"{max(res[k][0] for k in res if 'f32' in k)}); P1 "
          f"{t1 - t0:.1f} s, P2 {t2 - t1:.1f} s, P3 {t3 - t2:.1f} s, P4 "
          f"{time.time() - t3:.1f} s: "
          + "; ".join(f"{k} at {v[2]} (plain on {v[3]}: {v[1]:.1f} ms)"
                      for k, v in res.items()), flush=True)
    return res


def phase_probes():
    """The probe entry points at their default shapes, launch counts set
    to 0 before and read after; returns (rows by module, counts)."""
    from kangaroo_torch.ops import jump_cuda, probe_cuda
    from kangaroo_torch.probes import (layout_probe, pkbench, pkdelta, pkinv,
                                       probe_ops)

    probe_cuda.LAUNCHES.clear()
    jump_cuda.LAUNCHES = 0
    t = time.time()
    rows = {}
    for mod in (pkbench, probe_ops, layout_probe, pkdelta, pkinv):
        name = mod.__name__.rsplit(".", 1)[1]
        print(f"[7 probes] {name}", flush=True)
        rows[name] = mod.run()
    torch.cuda.synchronize()
    counts = dict(probe_cuda.LAUNCHES, **{"walk/plain": jump_cuda.LAUNCHES})
    idle = sorted({r["key"] for rs in rows.values() for r in rs
                   if not counts.get(r["key"])})
    print(f"[7 probes] entry points {time.time() - t:.1f} s; launches "
          f"{counts}", flush=True)
    print("[7 probes] add-class chains, SASS instructions per round of "
          "kt_field_chain<op> (a loop trip over its rounds, the loop's "
          "counter, compare and branch included) against the bound's "
          "slots, and those of the ALU pipe (the design's floor): "
          + "; ".join(
              f"{r['key'].split('/')[1]} {r['sass']['per_round']:.2f} against "
              f"{r['sass']['bound_slots']}, ALU "
              f"{r['sass']['alu_per_round']:.2f} ("
              f"{r['design_bound_ms']:.3f} ms against the bound's "
              f"{r['bound_ms']:.3f})" for r in rows["pkbench"]
              if "sass" in r), flush=True)
    p2 = rows["probe_ops"] + rows["layout_probe"]
    top = max(p2, key=lambda r: r.get("imad_rate", 0.0))
    print(f"[7 probes] P2 shares of their bounds: "
          + ", ".join(f"{r.get('op') or r['variant']} "
                      f"{100 * r['share']:.1f} %" for r in p2)
          + f"; highest IMAD rate {top['imad_rate']:.4g}/s ("
          f"{top.get('op') or top['variant']}), "
          f"{100 * top['imad_rate'] / jump_cuda.IMAD_PEAK:.1f} % of the "
          f"derived IMAD_PEAK {jump_cuda.IMAD_PEAK:.4g}/s; "
          f"{top['clock']}", flush=True)
    if idle:
        raise SystemExit(f"probe kernels not launched by their entry "
                         f"points: {idle}")
    return rows, counts


def phase_check():
    """-check on the card, launch counts set to 0 before and read after."""
    from kangaroo_torch.core.check import run_self_check
    from kangaroo_torch.ops import jump_cuda, probe_cuda

    probe_cuda.LAUNCHES.clear()
    jump_cuda.LAUNCHES = 0
    jump_cuda.SYM_LAUNCHES = 0
    t = time.time()
    ok = run_self_check("cuda")
    torch.cuda.synchronize()
    used = {"walk, plain": jump_cuda.LAUNCHES,
            "walk, symmetry": jump_cuda.SYM_LAUNCHES,
            "fe_mul (P1, one round)": probe_cuda.LAUNCHES[
                probe_cuda.kernel_key("field_chain", "mul")],
            "fe_inv (P1, one round)": probe_cuda.LAUNCHES[
                probe_cuda.kernel_key("field_chain", "inv")]}
    print(f"[8 check] run_self_check on the card: {ok}, "
          f"{time.time() - t:.1f} s; kernel launches {used}", flush=True)
    if not ok or not all(used.values()):
        raise SystemExit("-check failed on the card, or did not run "
                         "through the kernels")


def _probe_entries(rows, counts, cmp):
    """One kernels-line entry per row of the probe entry points (the
    production walk's pkbench row is the walk's own entry)."""
    out = []
    for mod, rs in rows.items():
        for r in rs:
            key = r["key"]
            if key == "walk/plain":
                continue
            err, p_ms, cmp_shape, p_shape = cmp[key]
            label = r.get("label") or r.get("op") or r.get("variant")
            out.append({
                "name": f"{key} ({mod}: {label})",
                "route": "cuda",
                "source": PROBE_SOURCE,
                "replaces": PROBE_REPLACES[mod],
                "launches": counts[key],
                "max_abs_err": err,
                "ms": r["ms"],
                "plain_ms": p_ms,
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": None,
                "shape": r["shape"],
                "compare_shape": cmp_shape,
                "plain_shape": p_shape,
            })
            if "sass" in r:
                out[-1]["sass_per_round"] = r["sass"]["per_round"]
                out[-1]["bound_slots_per_round"] = r["sass"]["bound_slots"]
                out[-1]["sass_alu_per_round"] = r["sass"]["alu_per_round"]
            if "design_bound_ms" in r:
                out[-1]["design_bound_ms"] = r["design_bound_ms"]
            if mod == "pkinv":
                out[-1].update({k: r[k] for k in (
                    "ns_per_lane", "regs", "local_bytes", "smem",
                    "blocks_per_sm")})
            if mod in ("probe_ops", "layout_probe"):
                # P2: the SASS opcodes of one trip of its loop, its share of
                # its bound (the latency floor's where it has one), the SM
                # clock sampled while the module ran
                out[-1].update({k: r[k] for k in (
                    "trip", "share", "clock", "blocks_per_sm")
                    if k in r})
                if r.get("floor_ms") is not None:
                    out[-1]["latency_floor_ms"] = r["floor_ms"]
    return out


def _shard_devices():
    """Two shards' devices: cuda:0 and cuda:1 when the host has two
    cards, else cuda:0 twice (side by side on its streams)."""
    two = torch.cuda.device_count() >= 2
    return (["cuda:0", "cuda:1"] if two else ["cuda:0", "cuda:0"],
            "cuda:0 and cuda:1" if two else
            "both on cuda:0 (one card), each on its own stream")


def phase_shard_tick(state, sym):
    """10a: the window as one launch and as two lane shards on their own
    streams (parallel/sharding.py), every output bit-equal; then both
    timed in turns (one, two, two, one; host clock around a synchronize,
    since two streams run).  Returns the sharded path's launches and
    (one launch ms, two shards ms)."""
    from kangaroo_torch.ops import jump_cuda, jump_ref
    from kangaroo_torch.parallel import sharding

    tag = "10a sharded window" + (", symmetry" if sym else "")
    dev = torch.device("cuda", 0)
    tabs = _tables(dev, sym) + [jump_ref.dp_limb_masks(DP_FULL, dev)]
    names, where = _shard_devices()
    shards = sharding.make_shards([torch.device(x) for x in names], N_FULL,
                                  jump_cuda.LANE_QUANTUM)
    herds = [list(h) + [h[3] if sym else None]
             for h in sharding.shard_herd(shards, *state)]
    tables = sharding.replicate(shards, *tabs)
    one_in = [t.clone() for t in state]
    tick = sharding.make_sharded_jump_steps(shards, 256, SLOTS_FULL, sym)

    def one():
        return _walk(jump_cuda.jump_steps_with_dp, one_in, tabs[:3],
                     tabs[3], 256, SLOTS_FULL)

    def two():
        out = tick(herds, tables)
        sharding.synchronize(shards)
        return out

    want = one()
    torch.cuda.synchronize()
    _reset_counts()
    outs = two()
    launches = _read_counts(sym, tag)
    got = [torch.cat([o[k].to(dev) for o in outs], dim=-1)
           for k in range(len(want))]
    errs = {n: int((a.long() - b.long()).abs().max())
            for n, a, b in zip(NAMES + ("symclass",), got, want)}
    dps = int(want[3].sum())
    del want, got, outs
    ms = {one: [], two: []}
    for fn in (one, two, two, one):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms[fn].append((time.perf_counter() - t) * 1e3)
    one_ms, two_ms = (sum(ms[f]) / 2 for f in (one, two))
    print(f"[{tag}] {N_FULL} lanes x 256 steps, dp {DP_FULL}, "
          f"{SLOTS_FULL} slots: two shards of {N_FULL // 2} lanes "
          f"({where}), {launches} launches, {dps} DPs, max |shards - one "
          f"launch| {errs}; in turns one launch {ms[one][0]:.1f}, two "
          f"shards {ms[two][0]:.1f}, {ms[two][1]:.1f}, one launch "
          f"{ms[one][1]:.1f} ms (host clock): two shards "
          f"{two_ms / one_ms - 1:+.1%}", flush=True)
    if any(errs.values()) or launches != 2 or dps == 0:
        raise SystemExit(f"{tag}: the two shards differ from one launch")
    return launches, (one_ms, two_ms)


def phase_shard_solve(plain_st):
    """10b: in64 at 2^22 lanes on 2 shards with phase 5s's options; the
    walk must be 5s's plain solve's, jump for jump."""
    from pathlib import Path

    from kangaroo_torch.core.config import parse_config_file
    from kangaroo_torch.core.solver import KangarooSolver, SolverOptions

    tag = "10b sharded solve"
    names, where = _shard_devices()
    cfg = parse_config_file(
        str(Path(__file__).resolve().parent / "fixtures" / "in64.txt"))
    opts = SolverOptions(nb_kangaroo=N_FULL, nb_run=0, seed=SEED,
                         device=names, quiet=True)
    _reset_counts()
    t = time.time()
    solver = KangarooSolver(cfg, opts)
    res = solver.solve(0)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = _read_counts(False, tag)
    st = solver.stats
    _compact_count(tag, st.ticks * len(solver.shards))
    per_shard = list(zip(*st.compact_s))
    rate, rate5 = st.count / st.time, plain_st.count / plain_st.time
    print(f"[{tag}] in64.txt at {N_FULL} lanes in {len(solver.shards)} "
          f"shards of {N_FULL // len(solver.shards)} ({where}), dp "
          f"{solver.dp_size}, nb_run {opts.nb_run} x "
          f"{solver.windows_per_tick} windows, slots {solver.n_slots}: key "
          f"{hex(res.private_key) if res else None}; wall {wall:.2f} s "
          f"(herd {st.herd_time:.2f} s, walk {st.time:.2f} s, {st.ticks} "
          f"ticks, 2^{math.log2(max(st.count, 1)):.2f} jumps, dead "
          f"{st.dead}, lost {st.lost}); loop {rate / 1e9:.3f} G jumps/s "
          f"against phase 5s's {rate5 / 1e9:.3f} ({rate / rate5 - 1:+.1%}); "
          f"compaction seconds per tick, shard by shard: "
          + "; ".join(f"shard {i}: " + ", ".join(f"{x:.4f}" for x in xs)
                      for i, xs in enumerate(per_shard))
          + f"; launches {launches}", flush=True)
    if res is None or res.private_key != IN64_KEY:
        raise SystemExit(f"{tag}: in64 did not give the known key")
    same = (st.ticks, st.count, st.dead, st.lost) == (
        plain_st.ticks, plain_st.count, plain_st.dead, plain_st.lost)
    if len(solver.shards) != 2 or not same:
        raise SystemExit(f"{tag}: the 2-shard walk differs from phase 5s's "
                         f"(ticks, jumps, dead, lost {st.ticks}, {st.count}, "
                         f"{st.dead}, {st.lost} against {plain_st.ticks}, "
                         f"{plain_st.count}, {plain_st.dead}, "
                         f"{plain_st.lost})")
    return launches, [sum(xs) / len(xs) for xs in per_shard]


def phase_nwin():
    """10n: in64 plain with -nbrun 512 -nwin 2 through the solver: each
    tick walks 2 windows of 512 steps before one drain."""
    from pathlib import Path

    from kangaroo_torch.core.config import parse_config_file
    from kangaroo_torch.core.solver import KangarooSolver, SolverOptions

    tag = "10n -nwin"
    cfg = parse_config_file(
        str(Path(__file__).resolve().parent / "fixtures" / "in64.txt"))
    opts = SolverOptions(nb_kangaroo=N_FULL, nb_run=512, windows_per_tick=2,
                         seed=SEED, device="cuda", quiet=True)
    _reset_counts()
    t = time.time()
    solver = KangarooSolver(cfg, opts)
    res = solver.solve(0)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = _read_counts(False, tag)
    st = solver.stats
    # one call a tick for both windows
    _compact_count(tag, st.ticks * len(solver.shards))
    print(f"[{tag}] in64.txt at {N_FULL} lanes, -nbrun 512 -nwin 2, dp "
          f"{solver.dp_size}, slots {solver.n_slots}: key "
          f"{hex(res.private_key) if res else None}; wall {wall:.2f} s "
          f"(herd {st.herd_time:.2f} s, walk {st.time:.2f} s, {st.ticks} "
          f"ticks, {st.count} jumps, dead {st.dead}, lost {st.lost}); "
          f"{st.count / st.time / 1e9:.3f} G jumps/s; launches {launches}",
          flush=True)
    if res is None or res.private_key != IN64_KEY:
        raise SystemExit(f"{tag}: in64 did not give the known key")
    if (solver.windows_per_tick != 2
            or st.count != st.ticks * 2 * 512 * N_FULL
            or launches != 2 * st.ticks):
        raise SystemExit(f"{tag}: the count is not ticks x 2 x 512 x "
                         f"{N_FULL}")
    return launches


def phase_multihost():
    """10m: 2 processes over gloo, each walking 2^20 lanes of one herd
    on the card; returns their launches."""
    from kangaroo_torch.parallel import multihost

    tag = "10m multi-process"
    res = multihost.run(procs=2, device="cuda", lanes=1 << 21, steps=256,
                        dp=DP_FULL, timeout=300)
    print(f"[{tag}] {res['processes']} processes over gloo on "
          f"{res['device_name']}, {res['lanes_per_process']} lanes each x "
          f"{res['steps']} steps, dp {res['dp']}: walk seconds "
          f"{res['walk_s']}, launches {res['launches']}, plain walk calls "
          f"{res['plain_calls']}; max |gathered - one process| "
          f"{res['max_abs_err']}; reduced DP hits {res['reduced_hits']} "
          f"against {res['one_process_hits']}", flush=True)
    if (not res["bit_equal"] or res["reduced_hits"] != res["one_process_hits"]
            or res["reduced_hits"] == 0 or min(res["launches"]) < 1
            or any(res["plain_calls"])):
        raise SystemExit(f"{tag}: the multi-process walk is wrong")
    return sum(res["launches"])


# phase 10w: the weak-scaling harness at its card defaults, then at the
# solver's in64 tick (phase 5s's auto DP at 2^22 lanes: dp 14, 1024
# steps, 6 slots, ~2^18 DPs a tick), sizes 1 and 2; (label, run_sizes
# options, whether the first ticks are held against the plain walk: it
# takes 65 s or more for 1024 steps, so the in64 tick's are held against
# the kernel on those lanes alone, which phase 3 holds to the plain walk
# at the same dp and slots)
WEAK_SHAPES = (("defaults", {}, True),
               ("in64 tick", dict(nb_run=NB_FULL, dp_bits=DP_FULL,
                                  slots=SLOTS_FULL), False))


def phase_weak_scaling(compact_10b):
    """10w: kangaroo_torch.parallel.weak_scaling run_sizes on the card
    at sizes 1 and 2 (two cards, or cuda:0 twice), at each shape of
    WEAK_SHAPES: each size's first tick bit-equal to the plain walk (or
    the kernel alone) on phase 3's lanes (PER_BLOCK of every block; both
    sizes' lanes in one call), the drain under half the kernel time at
    every size;
    prints each row, the caveat where the shards share the card, and
    10b's compaction a tick beside the harness's.  Returns the plain
    kernel's launches."""
    from kangaroo_torch.ops import jump_cuda, jump_ref
    from kangaroo_torch.parallel import weak_scaling
    from kangaroo_torch.profile_walk import cuda_ms

    names, where = _shard_devices()
    dev = torch.device("cuda", 0)
    launches = 0
    for label, kw, plain in WEAK_SHAPES:
        tag = f"10w weak scaling, {label}"
        kept = []

        def keep(nd, inputs, shards, outs):
            idx = _subset("cpu", shards[-1].hi).numpy()
            sub_in = [torch.from_numpy(a[..., idx].astype(np.int32))
                      for a in inputs[:3]]
            sub_out = []
            for k in range(len(NAMES)):
                parts = []
                for sh, o in zip(shards, outs):
                    sel = idx[(idx >= sh.lo) & (idx < sh.hi)] - sh.lo
                    parts.append(o[k][..., torch.from_numpy(sel).to(
                        sh.device)].cpu())
                sub_out.append(torch.cat(parts, dim=-1))
            kept.append((sub_in, sub_out, inputs[3:]))

        _reset_counts()
        results, devices = weak_scaling.run_sizes(
            sizes=(1, 2), device=names, on_first_tick=keep, reps=WEAK_REPS,
            **kw)
        launches += _read_counts(False, tag)
        _compact_count(tag, (1 + WEAK_REPS)
                       * sum(r["devices"] for r in results))
        nb_run, slots = results[0]["nb_run"], results[0]["slots"]
        tabs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in kept[0][2]]
        pin = [torch.cat([k[0][i] for k in kept], dim=-1).to(dev)
               for i in range(3)]
        ref = jump_ref if plain else jump_cuda
        p, p_ms = cuda_ms(lambda: ref.jump_steps_with_dp(
            *pin, *tabs, nb_run=nb_run, slots=slots))
        got = [torch.cat([k[1][i] for k in kept], dim=-1).to(dev)
               for i in range(len(NAMES))]
        errs = _errors(got, p, False)
        caveat = weak_scaling.payload(results, devices).get("caveat")
        for r in results:
            print(f"[{tag}] {r['devices']} shard(s) of "
                  f"{r['lanes_per_device']} lanes ({where}), "
                  f"{r['nb_run']} steps, dp {r['dp_bits']}, {r['slots']} "
                  f"slots: kernel {r['kernel_s_per_tick']:.6f} s a tick, "
                  f"{r['mks']:.1f} M jumps/s ({r['mks_per_device']:.1f} a "
                  f"shard, efficiency {r['weak_scaling_eff']:.4f}); drain "
                  f"(compaction) {r['drain_s_per_tick']:.6f} s a tick, "
                  f"shard by shard {r['drain_s_per_shard']}; "
                  f"{r['dps_per_tick']} DPs a tick, {r['lost_per_tick']} "
                  f"lost", flush=True)
        what = "the plain walk" if plain else "the kernel alone"
        print(f"[{tag}] first tick of each size against {what} on "
              f"{pin[0].shape[1]} lanes ({PER_BLOCK} per block, both sizes "
              f"in one call, {p_ms:.1f} ms, {int(p[3].sum())} DPs): max "
              f"|sharded - reference| {errs}; launches {launches}; "
              f"caveat: {caveat}", flush=True)
        _reset_counts()  # the kernel-alone check is not the path's
        if any(errs.values()) or int(p[3].sum()) == 0:
            raise SystemExit(f"{tag}: the sharded tick differs from "
                             f"{what}: {errs}")
        slow = [r["devices"] for r in results
                if not r["drain_s_per_tick"] < 0.5 * r["kernel_s_per_tick"]]
        if slow or [r["devices"] for r in results] != [1, 2]:
            raise SystemExit(f"{tag}: the drain is not under half the "
                             f"kernel time at sizes {slow}")
        del p, got, pin, kept
        torch.cuda.empty_cache()
    print(f"[10w weak scaling] 10b's compaction a tick in the solver loop "
          f"(its wait for the shard's windows included), shard by shard: "
          + ", ".join(f"{x:.4f} s" for x in compact_10b), flush=True)
    return launches


def phase_stats(sym):
    """11: a STATS batch of STATS_KEYS keys of in40_1000 through the
    solver on the card, held key by key against the stock binary's
    stream, then the kernel against the plain walk on its first herd;
    returns (launches, mean ops/sqrt(N), the check's largest error)."""
    from pathlib import Path

    from kangaroo_torch import stats_batch, stats_summary
    from kangaroo_torch.core import curve
    from kangaroo_torch.core.config import parse_config_file
    from kangaroo_torch.core.solver import SolverOptions

    tag = "11 STATS" + (" -sym" if sym else " plain")
    root = Path(__file__).resolve().parent
    cfg = parse_config_file(str(root / "fixtures" / "in40_1000.txt"))
    ref = stats_summary.read_ref(
        str(root / "hw_evidence" / "stats_ref1000_r05.txt"))
    opts = SolverOptions(nb_kangaroo=STATS_NK, dp_size=STATS_DP,
                         nb_run=STATS_NBRUN, windows_per_tick=1,
                         device="cuda", quiet=True, symmetry=sym)
    keys = range(STATS_KEYS)
    _reset_counts()
    t = time.time()
    rows = stats_batch.run_batch(cfg, opts, keys, seed0=SEED)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = _read_counts(sym, tag)
    # a herd a key, then one launch a tick with dead lanes
    _herd_count(tag, least=len(rows))
    _compact_count(tag, sum(r.ticks for r in rows))
    sqrt_n = stats_batch.sqrt_range(cfg)
    m, se = stats_summary.mean_se([r.count / sqrt_n for r in rows])
    model = rows[0].expected / sqrt_n
    lag = 3 * STATS_NK * STATS_NBRUN / sqrt_n
    n = len(rows)

    def per(f):
        return sum(f(r) for r in rows) / n

    ref_m = sum(ref[k][0] for k in keys) / n / sqrt_n
    ref_dead = sum(ref[k][1] for k in keys) / n
    print(f"[{tag}] in40_1000.txt keys 0..{n - 1}, {opts.nb_kangaroo} "
          f"lanes, dp {opts.dp_size}, nb_run {opts.nb_run}, a tick "
          f"{opts.nb_kangaroo * opts.nb_run / sqrt_n:.4f}*sqrt(N): "
          f"ops/sqrtN mean {m:.4f} +- {se:.4f} (SE) against the model "
          f"{model:.4f} (+ lag 0..{lag:.4f}; mean - model "
          f"{(m - model) / se:+.2f} SE); per key dead "
          f"{per(lambda r: r.dead):.3f} (duplicate DPs "
          f"{per(lambda r: r.dup):.3f}), ticks {per(lambda r: r.ticks):.2f},"
          f" herd {per(lambda r: r.herd_s):.4f} s, walk "
          f"{per(lambda r: r.walk_s):.4f} s; stock stream on the same keys "
          f"{ref_m:.4f}*sqrt(N), dead {ref_dead:.3f}; wall {wall:.1f} s; "
          f"launches {launches}", flush=True)
    bad = [r.key for r in rows
           if r.priv is None or r.priv != ref[r.key][2]
           or curve.mul(r.priv) != cfg.keys[r.key]]
    if bad:
        raise SystemExit(f"{tag}: keys {bad[:10]} differ from the stock "
                         f"stream's Priv (or priv*G from the key)")
    if launches != sum(r.ticks for r in rows):
        raise SystemExit(f"{tag}: {launches} launches for "
                         f"{sum(r.ticks for r in rows)} ticks")
    if sym:
        # the measured 1000-key mean, which carries the same lag
        want, want_se = SYM_MEAN_1000
        tol = 5 * math.hypot(se, want_se)
        print(f"[{tag}] against the port's 1000-key -sym mean {want:.4f} "
              f"+- {want_se:.4f}: {(m - want) / math.hypot(se, want_se):+.2f}"
              f" SE (the model {model:.4f} is missed: PERF.md section 7)",
              flush=True)
        lo, hi = want - tol, want + tol
    else:
        lo, hi = model - 5 * se, model + lag + 5 * se
    if not lo <= m <= hi:
        raise SystemExit(f"{tag}: mean {m:.4f} (SE {se:.4f}) is not in "
                         f"[{lo:.4f}, {hi:.4f}]")
    cmp_err = _stats_compare(cfg, opts, tag)
    return launches, m, cmp_err


def _stats_compare(cfg, opts, tag):
    """11: the walk kernel against the plain walk on the batch's first
    herd (key 0's, drawn from seed SEED as the solver draws it) at the
    batch's window: nb_run steps at its DP with the slot count the
    solver picks, STATS_CMP_WINDOWS windows in a row, each window's
    inputs the kernel's last outputs; tolerance 0.  These launches come
    after the batch's counts were read.  Returns the largest error."""
    from kangaroo_torch.constants import TAME
    from kangaroo_torch.core import herd as herd_mod
    from kangaroo_torch.core.jumptable import create_jump_table
    from kangaroo_torch.core.solver import KangarooSolver, slots_for_window
    from kangaroo_torch.ops import jump_cuda, jump_ref
    from kangaroo_torch.utils import rng as rng_mod

    sym = opts.symmetry
    solver = KangarooSolver(cfg, opts)
    solver.init_search_key(0)
    slots = slots_for_window(opts.nb_run, opts.dp_size, opts.nb_kangaroo)
    (herd,) = herd_mod.create_herd_shards(
        opts.nb_kangaroo, solver.range_power, solver.width_div2,
        solver.key_to_search, solver.shards, TAME, rng_mod.MT19937(SEED),
        symmetry=sym)
    dev = herd[0].device
    state = list(herd) + ([torch.zeros(opts.nb_kangaroo, dtype=torch.int32,
                                       device=dev)] if sym else [])
    tabs = [torch.from_numpy(a.astype("int32")).to(dev)
            for a in create_jump_table(solver.range_power, sym).as_arrays()]
    masks = jump_ref.dp_limb_masks(opts.dp_size, dev)
    worst, dps, flips = 0, 0, 0
    for _ in range(STATS_CMP_WINDOWS):
        k = _walk(jump_cuda.jump_steps_with_dp, [t.clone() for t in state],
                  tabs, masks, opts.nb_run, slots)
        p = _walk(jump_ref.jump_steps_with_dp, [t.clone() for t in state],
                  tabs, masks, opts.nb_run, slots)
        errs = _errors(k, p, sym)
        worst = max(worst, max(errs.values()))
        if max(errs.values()) != 0:
            raise SystemExit(f"{tag}: kernel disagrees with the plain walk "
                             f"on the batch's herd: {errs}")
        dps += int(p[3].sum())
        if sym:
            flips += int((k[7] != state[3]).sum())
        state = list(k[:3]) + ([k[7]] if sym else [])
    print(f"[{tag} compare] key 0's herd, {opts.nb_kangaroo} lanes, "
          f"{STATS_CMP_WINDOWS} windows of {opts.nb_run} steps at dp "
          f"{opts.dp_size}, {slots} slots: {dps} DPs"
          + (f", {flips} class changes" if sym else "")
          + f"; max |kernel - plain| {worst}", flush=True)
    if dps == 0 or (sym and flips == 0):
        raise SystemExit(f"{tag}: the compared windows met no DP"
                         + (" or no class change" if sym else ""))
    return worst


# phase 11's -sym batch, run in a process of its own beside the plain
# one: both are bound by the host (a k*G and a drain per few ticks of
# one block), so together they take the longer one's time
STATS_CHILD = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke
launches, mean, err = chip_smoke.phase_stats(True)
print(json.dumps({"launches": launches, "mean": mean, "err": err,
                  "herd": chip_smoke.HERD_LAUNCHES}))
"""


def phase_stats_pair():
    """11: the plain batch here and the -sym batch in a child process at
    the same time (each counts its own kernel's launches); returns
    ((launches, mean, err) plain, (launches, mean, err) -sym), err the
    kernel-vs-plain check's; fails unless the -sym mean lies below the
    plain one on the same keys."""
    root = os.path.dirname(os.path.abspath(__file__))
    t = time.time()
    child = subprocess.Popen([sys.executable, "-c", STATS_CHILD], cwd=root,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        plain = timed("11", phase_stats, False)
        out, _ = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    SECONDS["11 sym"] = time.time() - t
    lines = out.splitlines()
    print("\n".join(lines[:-1]), flush=True)
    print(f"[11 sym seconds] {SECONDS['11 sym']:.1f} (from the start of "
          f"both batches)", flush=True)
    if child.returncode != 0:
        raise SystemExit(f"11 STATS -sym failed (exit {child.returncode}): "
                         f"{lines[-1] if lines else ''}")
    sym = json.loads(lines[-1])
    HERD_LAUNCHES.update(sym["herd"])
    print(f"[11 ratio] plain/-sym mean ops/sqrtN {plain[1] / sym['mean']:.4f}"
          f" against sqrt(2) {math.sqrt(2):.4f}", flush=True)
    if not sym["mean"] < plain[1]:
        raise SystemExit(f"11 STATS: the -sym mean {sym['mean']:.4f} is not "
                         f"below the plain one {plain[1]:.4f} on the same "
                         f"keys")
    return plain, (sym["launches"], sym["mean"], sym["err"])


def phase_graft():
    """13: the graft entry, kangaroo_torch.graft_entry, on the card.
    (a) entry()'s window at its contract width (512 lanes, which the
    kernel walks widened to one block) bit-equal to the plain walk on
    the CPU over every lane, and at the main path's width (2^22 lanes)
    to the plain walk on the card on PER_BLOCK lanes of every block; fn
    called twice on the same arguments gives equal outputs (it walks a
    copy of the herd).  (b) dryrun_multichip on 1 shard and on 2 shards
    of cuda:0, the shards' outputs concatenated in lane order bit-equal
    to the plain walk on the CPU over the whole herd, the card's example
    inputs equal to the CPU's.  (c) python -m kangaroo_torch.graft_entry
    in a process of its own prints both OK lines.  Tolerance 0, py mod
    p.  Returns the plain kernel's launches on the entry's and on the dry
    run's path, and the largest error against the plain walk."""
    from pathlib import Path

    from kangaroo_torch import graft_entry as ge
    from kangaroo_torch.ops import jump_ref
    from kangaroo_torch.profile_walk import cuda_ms

    tag = "13 graft"
    cpu = torch.device("cpu")
    entry_launches, worst = 0, 0
    for n in (512, N_FULL):
        t = time.time()
        fn, args = ge.entry(n_lanes=n)
        torch.cuda.synchronize()
        herd_s = time.time() - t
        _reset_counts()
        out, ms = cuda_ms(lambda: fn(*args))
        again = fn(*args)
        torch.cuda.synchronize()
        launches = _read_counts(False, f"{tag} entry")
        entry_launches += launches
        # every lane on the CPU at 512; at 2^22 PER_BLOCK lanes of every
        # block on the card, as phase 3 does
        small = n == 512
        dev = args[0].device
        idx = torch.arange(n, device=dev) if small else _subset(dev)
        where = cpu if small else dev
        want = jump_ref.jump_steps_with_dp(
            *(a[..., idx].to(where) for a in args[:3]),
            *(a.to(where) for a in args[3:]), nb_run=ge.NB_RUN,
            slots=ge.SLOTS)
        errs = _errors([o[..., idx].to(where) for o in out], want, False)
        repeat = _errors(out, again, False)
        print(f"[{tag} entry] {n} lanes x {ge.NB_RUN} steps, dp "
              f"{ge.DP_SIZE}, {ge.SLOTS} slots: fn {ms:.3f} ms (CUDA "
              f"events; the copy of the herd included), inputs "
              f"{herd_s:.1f} s, {launches} launches for 2 calls, "
              f"{int(out[3].sum())} DPs; plain walk on {where} over "
              f"{idx.numel()} lanes: max |kernel - plain| {errs}; second "
              f"call against the first {repeat}", flush=True)
        worst = max(worst, *errs.values())
        if any(errs.values()) or any(repeat.values()) or launches != 2:
            raise SystemExit(f"{tag}: entry()'s window at {n} lanes is "
                             f"wrong or not repeatable")
        del fn, args, out, again
    torch.cuda.empty_cache()
    dry_launches = 0
    for n, device in ((1, "cuda"), (2, ["cuda:0", "cuda:0"])):
        _reset_counts()
        outs = ge.dryrun_multichip(n, device=device)
        torch.cuda.synchronize()
        launches = _read_counts(False, f"{tag} dry run")
        dry_launches += launches
        lanes = ge.DRY_LANES_PER_DEVICE * n
        card_in = ge._example_inputs(lanes)
        cpu_in = ge._example_inputs(lanes, device="cpu")
        in_errs = {name: int((a.to(cpu).long() - b.long()).abs().max())
                   for name, a, b in zip(("px", "py", "d"), card_in,
                                         cpu_in)}
        want = jump_ref.jump_steps_with_dp(*cpu_in, nb_run=ge.DRY_NB_RUN,
                                           slots=ge.SLOTS)
        got = [torch.cat([o[k].to(cpu) for o in outs], dim=-1)
               for k in range(len(NAMES))]
        errs = _errors(got, want, False)
        worst = max(worst, *errs.values())
        print(f"[{tag} dry run] {n} shard(s) of {ge.DRY_LANES_PER_DEVICE} "
              f"lanes on {device} x {ge.DRY_NB_RUN} steps: {launches} "
              f"launches; max |shards - plain| {errs}; card inputs "
              f"against the CPU's {in_errs}", flush=True)
        if (any(errs.values()) or any(in_errs.values()) or launches != n
                or len(outs) != n):
            raise SystemExit(f"{tag}: the dry run on {n} shard(s) is wrong")
    t = time.time()
    r = subprocess.run([sys.executable, "-m", "kangaroo_torch.graft_entry"],
                       cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True, timeout=300)
    lines = r.stdout.splitlines()
    print(f"[{tag} module] python -m kangaroo_torch.graft_entry: exit "
          f"{r.returncode} in {time.time() - t:.1f} s, {lines}", flush=True)
    if r.returncode != 0 or lines != ["entry OK", "dryrun_multichip OK"]:
        raise SystemExit(f"{tag}: the module failed: {r.stderr[-2000:]}")
    return entry_launches, dry_launches, worst


def timed(phase, fn, *args, **kw):
    """fn(*args, **kw), with its seconds printed and kept."""
    t = time.time()
    out = fn(*args, **kw)
    SECONDS[phase] = time.time() - t
    print(f"[{phase} seconds] {SECONDS[phase]:.1f}", flush=True)
    return out


SECONDS = {}


def main():
    t_main = time.time()
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    timed("2", phase_build)
    herd_entry = timed("3h", phase_herd, dev)
    compact_entry = timed("3c", phase_compact, dev)
    herd, herd_s = _herd(N_FULL, dev)
    cmp_plain = timed("3", phase_compare, herd, dev, PLAIN_WINDOWS)
    ms, bound, by = timed("4", phase_full, herd, herd_s, dev)
    state, sym_herd_s = _sym_state(dev)
    cmp_sym = timed("3s", phase_compare, state, dev, SYM_WINDOWS)
    sym_ms, sym_bound, sym_by = timed("4s", phase_full, state, sym_herd_s,
                                      dev, ms)
    launches, _ = timed("5", phase_solve, "in56.txt", IN56_KEY)
    sym_launches, sym_st = timed("5s", phase_solve, "in64.txt", IN64_KEY,
                                 sym=True, tag="5s solve")
    _, plain_st = timed("5s plain", phase_solve, "in64.txt", IN64_KEY,
                        tag="5s solve, plain for comparison")
    print(f"[5s jumps] in64 with the same seed: -sym 2^"
          f"{math.log2(sym_st.count):.2f} jumps in {sym_st.ticks} ticks, "
          f"plain 2^{math.log2(plain_st.count):.2f} in {plain_st.ticks} "
          f"ticks (one solve each: the count to a key varies run to run)",
          flush=True)
    w_save, w_resume = timed("6", phase_work, False)
    ws_save, ws_resume = timed("6s", phase_work, True)
    w_split = timed("6w", phase_wsplit)
    sent = []
    net = timed("9", phase_net, False, plain_st, sent)
    net_sym = timed("9s", phase_net, True, sym_st, sent)
    wss_save, wss_resume = timed("9w", phase_wss, sent)
    timed("9v", phase_ingest, sent)
    del sent
    # 10a walks the herds of phases 3-4s (kept for it: no new k*G)
    shard_a, shard_a_ms = timed("10a", phase_shard_tick, herd, False)
    sym_shard_a, sym_shard_a_ms = timed("10a sym", phase_shard_tick, state,
                                        True)
    del herd, state
    torch.cuda.empty_cache()
    shard_b, compact_b = timed("10b", phase_shard_solve, plain_st)
    nwin = timed("10n", phase_nwin)
    multi = timed("10m", phase_multihost)
    weak = timed("10w", phase_weak_scaling, compact_b)
    torch.cuda.empty_cache()
    (stats, _, stats_err), (sym_stats, _, sym_stats_err) = (
        phase_stats_pair())
    # the kernels' max_abs_err covers phase 11's check as well
    cmp_plain = (max(cmp_plain[0], stats_err),) + tuple(cmp_plain[1:])
    cmp_sym = (max(cmp_sym[0], sym_stats_err),) + tuple(cmp_sym[1:])
    torch.cuda.empty_cache()
    cmp_probes = timed("7 compare", phase_probe_compare, dev)
    probe_rows, probe_counts = timed("7", phase_probes)
    timed("8", phase_check)
    graft_entry_k, graft_dry_k, graft_err = timed("13", phase_graft)
    # the plain kernel's max_abs_err covers phase 13's checks too
    cmp_plain = (max(cmp_plain[0], graft_err),) + tuple(cmp_plain[1:])
    kernels = [
        _entry("plain", launches, cmp_plain, ms, bound, by, {
            "5 in56 solve": launches, "6 in64 saving solve": w_save,
            "6 in64 resume": w_resume, "6w in64 -wsplit solve": w_split,
            "9 in64 client": net, "9w in64 -wss save": wss_save,
            "9w in64 -wss resume": wss_resume,
            "10a two shards": shard_a, "10b in64 2-shard solve": shard_b,
            "10n in64 -nwin 2": nwin, "10m 2 processes": multi,
            "10w weak scaling": weak,
            "11 STATS plain": stats, "13 graft entry": graft_entry_k,
            "13 graft dry run": graft_dry_k}),
        _entry("symmetry", sym_launches, cmp_sym, sym_ms, sym_bound,
               sym_by, {"5s in64 -sym solve": sym_launches,
                        "6s in64 -sym saving solve": ws_save,
                        "6s in64 -sym resume": ws_resume,
                        "9s in64 -sym client": net_sym,
                        "10a two shards": sym_shard_a,
                        "11 STATS -sym": sym_stats}),
    ] + [herd_entry, compact_entry] + _probe_entries(probe_rows, probe_counts,
                                                     cmp_probes)
    herd_entry["launches_by_path"] = HERD_LAUNCHES
    compact_entry["launches_by_path"] = COMPACT_LAUNCHES
    kernels[0]["ms_two_shards_10a"] = shard_a_ms
    kernels[1]["ms_two_shards_10a"] = sym_shard_a_ms
    print(f"[12 seconds] " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in SECONDS.items())
          + f"; whole run {time.time() - t_main:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
