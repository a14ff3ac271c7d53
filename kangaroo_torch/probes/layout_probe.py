"""Dependent chains against parallel work on the card
(`kt_raw_chain<layout, ILP>`).

The counterpart of scripts/layout_probe.py.  Every variant runs the
dependent chain x <- x * (x ^ k) + 1 (one LOP3 and one IMAD per element
and iteration) over the same element count, 256 * W; on Hopper the
TPU's array arrangements become the number of independent chains per
thread (ILP) against the number of threads:

  wide      ILP 1 over 256 W threads      (throughput reference)
  tall      ILP 2 over 128 W threads
  outer3d   ILP 4 over 64 W threads
  split16   ILP 16 over 16 W threads
  narrow1   ILP 1 over 16 W threads, 1/16 of the elements
  empty     the loop alone, x <- x + 1, on 16 W elements; nvcc sums it
            in closed form, so it times the launch and one read and
            write per element, the floor the others are read against
  wide_occ2 wide at 2 warps per scheduler: dynamic shared memory
            holds it to 2 blocks of 128 threads per SM (the walk
            kernel's occupancy at 190 registers), so it shows whether
            that occupancy hides the multiply's latency.

    python -m kangaroo_torch.probes.layout_probe [W=4096] [iters=131072] [variants]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import probe_cuda
from . import common

VARIANTS = {  # name: (ILP, fraction of the elements, op)
    "empty": (1, 16, "empty"), "narrow1": (1, 16, "layout"),
    "wide": (1, 1, "layout"), "tall": (2, 1, "layout"),
    "outer3d": (4, 1, "layout"), "split16": (16, 1, "layout"),
    "wide_occ2": (1, 1, "layout"),
}
W = 4096
ITERS = 1 << 17


def smem_of(variant: str) -> int:
    return common.OCC2_SMEM if variant == "wide_occ2" else 0


def inputs(w: int, dev) -> torch.Tensor:
    """The 256 W random start values; a variant chains the first
    1/fraction of them."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(
        rng.randint(0, 1 << 16, 256 * w).astype(np.int32)).to(dev)


def run(w: int = W, iters: int = ITERS, variants=None,
        verbose: bool = True):
    """Time each variant; returns the rows."""
    dev = common.require_card()
    variants = variants or list(VARIANTS)
    counts = common.sass_counts()
    a = inputs(w, dev)
    rows, base = [], None
    for v in variants:
        ilp, frac, op = VARIANTS[v]
        smem = smem_of(v)
        occ = probe_cuda.attrs("raw_chain", op, ilp, smem)
        if v == "wide_occ2" and occ["blocks_per_sm"] != 2:
            raise RuntimeError(f"wide_occ2 holds {occ['blocks_per_sm']} "
                               f"blocks per SM, not the walk's 2")
        if op == "layout":  # the chain's multiply must be in the SASS
            tag = f"kt_raw_chainILi{probe_cuda.RAW_OPS.index(op)}ELi{ilp}EE"
            common.require_insn(counts, tag, probe_cuda.RAW_SASS[op][1])
        x = a[:a.numel() // frac].clone()
        ms = common.time_ms(
            lambda: probe_cuda.raw_chain(op, x, iters, ilp, smem))
        if v == "empty":
            base = ms
        work = x.numel() * iters
        bound = probe_cuda.bound_ms(probe_cuda.RAW_COUNTS[op], work,
                                    8 * x.numel())
        rows.append({"variant": v, "key": probe_cuda.kernel_key(
                         "raw_chain", op, ilp),
                     "ms": ms, "ilp": ilp, "threads": x.numel() // ilp,
                     "elements": x.numel(),
                     "shape": f"{x.numel()} elements x {iters} iterations, "
                              f"ILP {ilp}" + (f", {smem} B dynamic shared "
                                              f"memory" if smem else ""),
                     "blocks_per_sm":
                         occ["blocks_per_sm"], "regs": occ["regs"],
                     "imad_rate": work / ms * 1e3 if op == "layout" else 0.0,
                     "ns_per_iter": None if base is None
                     else (ms - base) * 1e6 / iters,
                     "bound_ms": bound[0], "bound_by": bound[1]})
    if verbose:
        print(f"W={w}, iters={iters}", flush=True)
        for r in rows:
            extra = ("" if r["ns_per_iter"] is None
                     else f"  ({r['ns_per_iter']:7.1f} ns/iter over empty)")
            print(f"{r['variant']:10s} {r['ms']:9.3f} ms{extra}; ILP "
                  f"{r['ilp']}, {r['threads']} threads, "
                  f"{r['blocks_per_sm']} blocks/SM ({r['regs']} regs); "
                  f"IMAD {r['imad_rate'] / 1e12:.3f}e12/s; bound "
                  f"{r['bound_ms']:.3f} ms ({r['bound_by']})", flush=True)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    w = int(argv[0]) if len(argv) > 0 else W
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    common.header("layout_probe", ["kt_raw_chain<9,", "kt_raw_chain<10,"])
    run(w, iters, argv[2].split(",") if len(argv) > 2 else None)


if __name__ == "__main__":
    main()
