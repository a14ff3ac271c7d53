"""Cost of the walk's batched inversion on the card (`kt_inv_chain`).

The counterpart of scripts/pkinv.py: each variant is chained `iters`
times, x <- canon(fn(x) - x) | 1, so every iteration depends on the
last.  fn is the walk's per-thread Montgomery inversion over G lanes
(prefix products in local memory, one safegcd fe_inv, the unwind):

  cur      the inversion as the walk runs it, at G = 64; cur32, cur128
           and cur256 at G = 32, 128, 256
  nodiv    the same with fe_inv replaced by a copy (nodiv32, ...)
  none     fn(x) = x - x: the chain's own cost

The TPU's pair, stub and stub1024 probe Mosaic's per-call floor on
narrow arrays and have no Hopper counterpart; their question, what the
inversion costs per lane as G varies, is the G sweep.  Every variant
runs 2^W_log2 / 64 threads, the walk's thread count at its herd, so at
G lanes per thread it inverts 2^W_log2 * G / 64 lanes: the card holds
the walk's thread count whatever G.

    python -m kangaroo_torch.probes.pkinv [W_log2=22] [iters=64] [variants]
"""

from __future__ import annotations

import sys

import numpy as np

from ..ops import jump_cuda, probe_cuda
from . import common

W_LOG2 = 22
ITERS = 64
# nodiv before cur at each G: cur - nodiv is the fe_inv's share
DEFAULT = ["none", "nodiv32", "cur32", "nodiv", "cur", "nodiv128", "cur128",
           "nodiv256", "cur256"]


def inputs(w: int, dev):
    """A variant's random start x (16, w), every limb odd (pkinv.py's)."""
    return common.limbs(np.random.RandomState(0), 16, w, dev) | 1


def traffic_bytes(variant: str) -> int:
    """Device-memory bytes per lane and iteration of this design: x read
    and y written (2 x 64 B); cur and nodiv read x in both passes and
    write and read the prefix product (32 B each way, local memory that
    the L2 cache cannot hold at the walk's thread count)."""
    return 128 if variant == "none" else 256


def parse(name: str):
    """'cur' -> ('cur', GROUP), 'nodiv32' -> ('nodiv', 32)."""
    for var in ("nodiv", "none", "cur"):
        if name.startswith(var):
            return var, int(name[len(var):] or probe_cuda.GROUP)
    raise ValueError(f"unknown variant {name!r}")


def run(w_log2: int = W_LOG2, iters: int = ITERS, variants=None,
        verbose: bool = True):
    """Time each variant; returns the rows."""
    dev = common.require_card()
    threads = (1 << w_log2) // probe_cuda.GROUP
    rows, none_ms, nodiv_ms = [], None, {}
    for name in variants or DEFAULT:
        var, g = parse(name)
        w = threads * g
        x = inputs(w, dev)
        ms = common.time_ms(lambda: probe_cuda.inv_chain(var, x, iters, g))
        if var == "none":
            none_ms = ms
        elif var == "nodiv":
            nodiv_ms[g] = ms
        bound = probe_cuda.bound_ms(probe_cuda.inv_counts(var, g), w * iters,
                                    2 * 64 * w)
        floor = w * iters * traffic_bytes(var) / jump_cuda.HBM_RATE * 1e3
        a = probe_cuda.attrs("inv_chain", var, g)
        inv_us = (ms - nodiv_ms[g]) * 1e3 / iters if (
            var == "cur" and g in nodiv_ms) else None
        rows.append({"variant": name, "key": probe_cuda.kernel_key(
                         "inv_chain", var, g),
                     "group": g, "lanes": w, "ms": ms,
                     "shape": f"{w} lanes x {iters} iterations, G {g}",
                     "us_per_iter": ms * 1e3 / iters,
                     "ns_per_lane": ms * 1e6 / iters / w,
                     "ns_per_lane_over_none": None if none_ms is None
                     else (ms - none_ms) * 1e6 / iters / w,
                     "inv_us": inv_us, "traffic_floor_ms": floor,
                     "bound_ms": bound[0],
                     "bound_by": bound[1], **a})
    if verbose:
        print(f"threads: {threads}, iters: {iters}", flush=True)
        for r in rows:
            over = ("" if r["ns_per_lane_over_none"] is None
                    else f", {r['ns_per_lane_over_none']:.3f} over none")
            inv = ("" if r["inv_us"] is None else
                   f"; fe_inv (cur - nodiv) {r['inv_us']:.2f} us/iter")
            print(f"{r['variant']:10s} {r['ms']:9.3f} ms   "
                  f"{r['us_per_iter']:8.2f} us/inv-iter   "
                  f"{r['ns_per_lane']:.3f} ns/lane{over}{inv}; G "
                  f"{r['group']}, {r['lanes']} lanes; bound "
                  f"{r['bound_ms']:.3f} ms ({r['bound_by']}), this design's "
                  f"traffic floor {r['traffic_floor_ms']:.3f} ms; {r['regs']} "
                  f"regs, {r['local_bytes']} B local, {r['blocks_per_sm']} "
                  f"blocks/SM", flush=True)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    w_log2 = int(argv[0]) if len(argv) > 0 else W_LOG2
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    common.header("pkinv", ["kt_inv_chain"])
    run(w_log2, iters, argv[2].split(",") if len(argv) > 2 else None)


if __name__ == "__main__":
    main()
