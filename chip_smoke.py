#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (kangaroo_torch).

Drives the port's main path on one CUDA card and holds its walk kernel
against the plain PyTorch version, phase by phase; any fault raises and
the exit code is non-zero.  Run from the repository root:

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit;
  2. build: nvcc builds the walk kernels (plain and symmetry) from
     csrc/ (set-up time), with ptxas's register and spill report;
  3. plain kernel vs plain walk at the main path's shape: the kernel
     walks a 2^22-lane herd (256 blocks) once with slot overflow (dp 6,
     2 slots, 512 steps) and once as the solver runs it (dp 14, 6 slots,
     1024 steps); the plain walk runs the same window on 64 lanes of
     every block (2^14 lanes, corners of each block's thread x group
     grid included), and the kernel once more on those 2^14 lanes alone.
     The walk is exact per lane, so px, d, count and every DP slot must
     be bit-equal and py equal mod p (tolerance 0: integer arithmetic);
  4. full-width plain walk: 2^22 lanes x 1024 steps timed with CUDA
     events;
  3s. symmetry kernel vs plain symmetry walk, the same way, on a
     2^22-lane symmetry herd after one symmetry window (so that the
     class input holds both classes): dp 6, 2 slots, 512 steps, and
     dp 14, 6 slots, 256 steps; every output bit-equal, symclass and
     the canonical py included;
  4s. full-width symmetry walk, 2^22 x 1024, beside the plain one;
  5. end-to-end solve of fixtures/in56.txt at 2^22 lanes with the auto
     DP, through the plain kernel only (launch counts read around it);
  5s. end-to-end -sym solve of fixtures/in64.txt at 2^22 lanes with the
     auto DP, through the symmetry kernel only, then the plain in64
     solve with the same seed for its jump count;
  6. the kernels line, the card line and the result line.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

N_FULL = 1 << 22
NB_FULL = 1024
SLOTS_FULL = 6
DP_FULL = 14
PER_BLOCK = 64  # lanes of each block the plain walk checks
RANGE_POWER = 64
SEED = 0x5EED
IN56_KEY = 0x9FD2E30C451A6B
IN64_KEY = 0xCAFEBABE12345678
NAMES = ("px", "py", "d", "count", "dpx", "dpd", "step")
# (dp, slots, steps, overflow expected) of the kernel-vs-plain windows
PLAIN_WINDOWS = ((6, 2, 512, True), (DP_FULL, SLOTS_FULL, NB_FULL, False))
# the plain symmetry walk takes ~40 s per 512 steps on 2^14 lanes
SYM_WINDOWS = ((6, 2, 512, True), (DP_FULL, SLOTS_FULL, 256, False))


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
    from kangaroo_torch.ops import jump_cuda
    from kangaroo_torch.utils.build import BUILD_DIR

    t = time.time()
    lib = jump_cuda.build()
    log = (BUILD_DIR / f"{lib.name}.log").read_text()
    kinds = {"ILb0E": "plain:", "ILb1E": "symmetry:"}
    ptx = [next((v for k, v in kinds.items() if k in ln), ln.strip())
           if "entry function" in ln else ln.strip()
           for ln in log.splitlines()
           if "entry function" in ln or "registers" in ln or "spill" in ln]
    print(f"[2 build] {time.time() - t:.1f}s {lib.name}: "
          + " | ".join(ptx), flush=True)


def _herd(n, dev, sym=False):
    from kangaroo_torch.core import curve, herd
    from kangaroo_torch.utils.rng import MT19937

    wd2 = ((1 << RANGE_POWER) - 1) >> 1
    torch.cuda.synchronize()
    t = time.time()
    px, py, d = herd.create_herd(n, RANGE_POWER, wd2,
                                 curve.mul(0xDEADBEEF12345), 0,
                                 MT19937(SEED), device=dev, symmetry=sym)
    torch.cuda.synchronize()
    return (px, py, d), time.time() - t


def _tables(dev, sym=False):
    from kangaroo_torch.core.jumptable import create_jump_table

    return [torch.from_numpy(a.astype("int32")).to(dev)
            for a in create_jump_table(RANGE_POWER, sym).as_arrays()]


def _walk(fn, state, tabs, masks, nb_run, slots):
    """fn (the kernel's wrapper or the plain walk) on state (px, py, d
    and, in symmetry mode, symclass)."""
    sym = {"symmetry": True, "symclass": state[3]} if len(state) > 3 else {}
    return fn(*state[:3], *tabs, masks, nb_run=nb_run, slots=slots, **sym)


def _subset(dev):
    """PER_BLOCK lanes of every block of the kernel: the four corners of
    the block's thread x group grid and random others."""
    from kangaroo_torch.ops import jump_cuda

    q, t = jump_cuda.LANE_QUANTUM, jump_cuda.THREADS
    rs = np.random.RandomState(SEED)
    corners = [0, t - 1, q - t, q - 1]
    idx = [b * q + np.concatenate(
               [corners, rs.choice(q, PER_BLOCK - len(corners),
                                   replace=False)])
           for b in range(N_FULL // q)]
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
          + f"; bound {bound:.1f} ms ({by}: {jump_cuda.imad_per_jump():.1f} "
          f"IMAD/jump at {jump_cuda.IMAD_PEAK:.4g}/s, derived peak); this "
          f"design's traffic floor "
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
    jump_cuda.LAUNCHES = 0
    jump_cuda.SYM_LAUNCHES = 0
    jump_ref.CALLS = 0
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
    return launches, st


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


def _entry(label, launches, cmp, ms, bound, by):
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
    }


def main():
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    herd, herd_s = _herd(N_FULL, dev)
    cmp_plain = phase_compare(herd, dev, PLAIN_WINDOWS)
    ms, bound, by = phase_full(herd, herd_s, dev)
    del herd
    state, sym_herd_s = _sym_state(dev)
    cmp_sym = phase_compare(state, dev, SYM_WINDOWS)
    sym_ms, sym_bound, sym_by = phase_full(state, sym_herd_s, dev, ms)
    del state
    launches, _ = phase_solve("in56.txt", IN56_KEY)
    sym_launches, sym_st = phase_solve("in64.txt", IN64_KEY, sym=True,
                                       tag="5s solve")
    _, plain_st = phase_solve("in64.txt", IN64_KEY,
                              tag="5s solve, plain for comparison")
    print(f"[5s jumps] in64 with the same seed: -sym 2^"
          f"{math.log2(sym_st.count):.2f} jumps in {sym_st.ticks} ticks, "
          f"plain 2^{math.log2(plain_st.count):.2f} in {plain_st.ticks} "
          f"ticks (one solve each: the count to a key varies run to run)",
          flush=True)
    kernels = [
        _entry("plain", launches, cmp_plain, ms, bound, by),
        _entry("symmetry", sym_launches, cmp_sym, sym_ms, sym_bound,
               sym_by),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
