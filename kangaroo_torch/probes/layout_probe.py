"""Dependent chains against parallel work on the card
(`kt_raw_chain<layout, ILP>`).

The counterpart of scripts/layout_probe.py.  Every variant runs the
dependent chain x <- x * (x ^ (i + 1)) + 1 (one LOP3 and one IMAD per
element and iteration) over the same element count, 256 * W; on Hopper
the TPU's array arrangements become the number of independent chains
per thread (ILP) against the number of threads:

  wide        ILP 1 over 256 W threads      (throughput reference)
  tall        ILP 2 over 128 W threads
  outer3d     ILP 4 over 64 W threads
  split16     ILP 16 over 16 W threads
  narrow1     ILP 1 over 16 W threads, 1/16 of the elements: at the
              default W, 2048 warps, 3.9 a scheduler
  empty       the loop alone, x <- x + 1, on 16 W elements.  It runs its
              loop (its SASS, printed below, holds it): a trip of
              RAW_TRIP iterations is a counter add, a compare, a branch
              and one add of RAW_TRIP to x, the compilers adding the
              trip's ones at once.  So it is the loop's floor at
              narrow1's threads, the floor the others are read against
              (ns/iter over empty), and its bound counts the loop's
              instructions (probe_cuda.RAW_COUNTS)
  wide_walk   wide at the walk kernel's occupancy (its resident blocks
              per SM, read from its attributes: 4 blocks of 128 threads,
              4 warps a scheduler), held there by dynamic shared
              memory: whether that occupancy hides the chain's latency
  narrow1_lat, empty_lat
              the narrow1 and empty chains at one warp a scheduler (one
              block of 128 threads an SM): the latency of their
              dependent step, inner steps of which bound narrow1 and
              empty beside their operations (probe_cuda's peaks
              comment); printed in clocks at the sampled SM clock.

Each trip of a chain's loop unrolls 128 element-iterations of a thread
(probes.cuh RAW_TRIP), and the index i + 1 goes into the LOP3 as an
immediate (probes.cuh raw_index): one LOP3 and one IMAD an
element-iteration, the loop's counter, compare and branch once a trip.
Each row prints its time, its bound (operations or bytes, and the
latency floor where there is one) and its share, its occupancy, its IMAD
rate and the opcodes of one trip of its loop; the run prints the SM
clock and power sampled while it ran.

    python -m kangaroo_torch.probes.layout_probe [W=4096] [iters=131072] [variants]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import probe_cuda
from . import common

# name: (ILP, elements: all, 1/16 or one block an SM, op); the long rows
# first, so that the short ones run at the clock the card holds under load
VARIANTS = {
    "wide": (1, "all", "layout"), "tall": (2, "all", "layout"),
    "outer3d": (4, "all", "layout"), "split16": (16, "all", "layout"),
    "wide_walk": (1, "all", "layout"),
    "narrow1_lat": (1, "lat", "layout"), "narrow1": (1, "1/16", "layout"),
    "empty_lat": (1, "lat", "empty"), "empty": (1, "1/16", "empty"),
}
# the rows that run too few warps to hide their chain's latency, and the
# run at one warp a scheduler that measures it
LATENCY_OF = {"narrow1": "narrow1_lat", "empty": "empty_lat"}
W = 4096
ITERS = 1 << 17
# timed launches of the rows below 2^20 elements (a launch of well under
# a millisecond): the mean of more of them
SHORT_REPS = 20


def elements(variant: str, w: int, sms: int) -> int:
    """Elements a variant chains: 256 W, 16 W, or one block of THREADS
    threads an SM (sms SMs) at its ILP."""
    ilp, share, _ = VARIANTS[variant]
    return {"all": 256 * w, "1/16": 16 * w,
            "lat": sms * probe_cuda.THREADS * ilp}[share]


def inputs(w: int, dev) -> torch.Tensor:
    """The 256 W random start values; a variant chains the first of
    them."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(
        rng.randint(0, 1 << 16, 256 * w).astype(np.int32)).to(dev)


def kernel_tag(op: str, ilp: int) -> str:
    """The mangled-name tag of kt_raw_chain<op, ilp>."""
    return f"kt_raw_chainILi{probe_cuda.RAW_OPS.index(op)}ELi{ilp}EE"


def run(w: int = W, iters: int = ITERS, variants=None,
        verbose: bool = True):
    """Time each variant; returns the rows."""
    dev = common.require_card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = variants or list(VARIANTS)
    counts = common.sass_counts()
    trips = common.loop_trips()
    walk_blocks = common.walk_blocks() if "wide_walk" in variants else 0
    a = inputs(w, dev)
    rows = []
    with common.ClockSampler() as clk:
        for v in variants:
            ilp, _, op = VARIANTS[v]
            smem = (common.hold_to("raw_chain", op, ilp, walk_blocks)
                    if v == "wide_walk" else 0)
            occ = probe_cuda.attrs("raw_chain", op, ilp, smem)
            if op == "layout":  # the chain's multiply must be in the SASS
                common.require_insn(counts, kernel_tag(op, ilp),
                                    probe_cuda.RAW_SASS[op][1])
            n = elements(v, w, sms)
            x = a[:n].clone()
            ms = common.time_ms(
                lambda: probe_cuda.raw_chain(op, x, iters, ilp, smem),
                common.REPS if n >= 256 * w else SHORT_REPS)
            work = n * iters
            bound = probe_cuda.bound_ms(probe_cuda.RAW_COUNTS[op], work,
                                        8 * n)
            rows.append({
                "variant": v, "key": probe_cuda.kernel_key("raw_chain", op,
                                                           ilp),
                "ms": ms, "ilp": ilp, "threads": n // ilp, "elements": n,
                "shape": f"{n} elements x {iters} iterations, ILP {ilp}"
                         + (f", {smem} B dynamic shared memory ("
                            f"{walk_blocks} blocks/SM, the walk's)"
                            if smem else ""),
                "blocks_per_sm": occ["blocks_per_sm"], "regs": occ["regs"],
                "imad_rate": work / ms * 1e3 if op == "layout" else 0.0,
                "bound_ms": bound[0], "bound_by": bound[1],
                "trip": dict(common.kernel_sass(trips,
                                                kernel_tag(op, ilp)))})
    mhz = clk.median_mhz()
    by = {r["variant"]: r for r in rows}
    base = by.get("empty")
    for r in rows:
        r["clock"] = clk.summary()
        r["ns_per_iter"] = (None if base is None or r is base
                            else (r["ms"] - base["ms"]) * 1e6 / iters)
        lat = (by.get(LATENCY_OF[r["variant"]])
               if r["variant"] in LATENCY_OF else None)
        if r["variant"].endswith("_lat"):
            # the floor it measures: its own time
            r["floor_ms"] = r["ms"]
            r["step_clocks"] = r["ms"] * 1e-3 / iters * mhz * 1e6
        else:
            # inner steps of the step's latency: the latency run's time
            r["floor_ms"] = lat["ms"] if lat else None
        r["share"] = max(r["bound_ms"], r["floor_ms"] or 0.0) / r["ms"]
    if verbose:
        print(f"W={w}, iters={iters}; {clk.summary()}", flush=True)
        for r in rows:
            extra = ("" if r["ns_per_iter"] is None
                     else f"  ({r['ns_per_iter']:7.2f} ns/iter over empty)")
            floor = ("" if r["floor_ms"] is None else
                     f", latency floor {r['floor_ms']:.4f} ms"
                     + (f" ({r['step_clocks']:.2f} clocks a step)"
                        if "step_clocks" in r else ""))
            print(f"{r['variant']:11s} {r['ms']:9.4f} ms{extra}; ILP "
                  f"{r['ilp']}, {r['threads']} threads, "
                  f"{r['blocks_per_sm']} blocks/SM ({r['regs']} regs); "
                  f"IMAD {r['imad_rate'] / 1e12:.3f}e12/s; bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}){floor}: "
                  f"{100 * r['share']:.1f} %; a trip of its loop "
                  f"{r['trip']}", flush=True)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    w = int(argv[0]) if len(argv) > 0 else W
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    common.header("layout_probe", ["kt_raw_chain<9,", "kt_raw_chain<10,"])
    run(w, iters, argv[2].split(",") if len(argv) > 2 else None)


if __name__ == "__main__":
    main()
