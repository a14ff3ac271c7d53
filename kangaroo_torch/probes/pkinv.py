"""Cost of the walk's batched inversion on the card, in two layouts.

The counterpart of scripts/pkinv.py: each variant is chained `iters`
times, x <- canon(fn(x) - x) | 1, so every iteration depends on the
last.  fn is the per-thread Montgomery inversion over G lanes (prefix
products, one safegcd fe_inv, the unwind):

  cur      the inversion as the walk runs it, at G = 64; cur32, cur128
           and cur256 at G = 32, 128, 256
  nodiv    the same with fe_inv replaced by a copy (nodiv32, ...)
  none     fn(x) = x - x: the chain's own cost

These run in the walk's layout (`kt_inv_chain`): every pass of every
iteration reads the lanes from device memory and writes them back, and
the prefix products go to local memory, as the walk's do.  The variants
named `<variant>_chip<G>` (cur_chip32, nodiv_chip16, none_chip32, ...)
run the same function in the on-chip form (`kt_inv_chip`), the design
of the TPU kernel, which holds its block in VMEM for the whole loop:
each thread's G lanes and prefix products stay in shared memory, x is
read once and written once per launch, and nothing goes to local
memory.  At G = 32 both forms invert the same lane sets, so nodiv32 and
nodiv_chip32 compute the same function: the difference per lane is the
price of the walk's layout.

The TPU's pair, stub and stub1024 probe Mosaic's per-call floor on
narrow arrays and have no Hopper counterpart; their question, what the
inversion costs per lane as G varies, is the G sweep.  The walk-layout
variants run 2^W_log2 / 64 threads, the walk's thread count at its
herd, so at G lanes per thread they invert 2^W_log2 * G / 64 lanes.
The on-chip variants run one wave of the blocks that stay resident
(shared memory sets it: 4096 lanes an SM for cur and nodiv at G = 16
and 32).

    python -m kangaroo_torch.probes.pkinv [W_log2=22] [iters=64] [variants]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import jump_cuda, probe_cuda
from ..utils import sass
from . import common

W_LOG2 = 22
ITERS = 64
# nodiv before cur at each G and form: cur - nodiv is the fe_inv's
# share; none first in the walk layout and at each G of the on-chip form
# (whose occupancy differs by G): nodiv - none is the products' share
DEFAULT = ["none", "nodiv32", "cur32", "nodiv", "cur", "nodiv128", "cur128",
           "nodiv256", "cur256", "none_chip16", "nodiv_chip16", "cur_chip16",
           "none_chip32", "nodiv_chip32", "cur_chip32"]
CHIP = "_chip"


def inputs(w: int, dev):
    """A variant's random start x (16, w), every limb odd (pkinv.py's)."""
    return common.limbs(np.random.RandomState(0), 16, w, dev) | 1


def traffic_bytes(form: str, variant: str, iters: int) -> int:
    """Device-memory bytes per lane and launch of a form's design.  The
    walk layout: per iteration x read and y written (2 x 64 B); cur and
    nodiv read x in both passes and write and read the prefix product
    (32 B each way, local memory that the L2 cache cannot hold at the
    walk's thread count).  The on-chip form: x read once and written
    once (2 x 64 B), the function's own traffic."""
    if form == "chip":
        return 2 * 64
    return iters * (128 if variant == "none" else 256)


def parse(name: str):
    """'cur' -> ('walk', 'cur', GROUP), 'nodiv32' -> ('walk', 'nodiv',
    32), 'cur_chip32' -> ('chip', 'cur', 32)."""
    form = "chip" if CHIP in name else "walk"
    base = name.replace(CHIP, "")
    for var in ("nodiv", "none", "cur"):
        if base.startswith(var):
            return form, var, int(base[len(var):] or probe_cuda.GROUP)
    raise ValueError(f"unknown variant {name!r}")


def chip_lanes(variant: str, group: int, dev) -> int:
    """Lanes of one wave of kt_inv_chip<variant, group> on the card: its
    resident blocks per SM (shared memory and registers) x SMs x
    THREADS x G."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = probe_cuda.attrs("inv_chip", variant, group)["blocks_per_sm"]
    return sms * blocks * probe_cuda.THREADS * group


def launch(form: str, variant: str, x, iters: int, group: int):
    """One launch of the form's kernel on x (in place)."""
    fn = probe_cuda.inv_chip if form == "chip" else probe_cuda.inv_chain
    return fn(variant, x, iters, group)


def none_alu(trips: dict, group: int) -> float:
    """ALU-pipe instructions a lane and iteration of the on-chip none
    (kt_inv_chip<none, group>), from one trip of its loop (8 shared
    words loaded a lane): the design's reading beside the function's
    count (probe_cuda.inv_counts)."""
    ops = common.kernel_sass(
        trips, f"kt_inv_chipILi{probe_cuda.INV_VARIANTS.index('none')}"
        f"ELi{group}EE")
    return common.alu_count(ops) / (sass.count_class(ops, "LDS") / 8)


def run(w_log2: int = W_LOG2, iters: int = ITERS, variants=None,
        verbose: bool = True):
    """Time each variant; returns the rows."""
    dev = common.require_card()
    trips = common.loop_trips()
    threads = (1 << w_log2) // probe_cuda.GROUP
    chip_run = probe_cuda.chip_run()
    rows, none_ns, nodiv = [], {}, {}
    for name in variants or DEFAULT:
        form, var, g = parse(name)
        w = chip_lanes(var, g, dev) if form == "chip" else threads * g
        x = inputs(w, dev)
        ms = common.time_ms(lambda: launch(form, var, x, iters, g))
        ns = ms * 1e6 / iters / w
        if var == "none":
            none_ns[form] = ns
        elif var == "nodiv":
            nodiv[form, g] = (ms, ns)
        counts = probe_cuda.inv_counts(var, g)
        bound = probe_cuda.bound_ms(counts, w * iters, 2 * 64 * w)
        design = (probe_cuda.inv_chip_counts(var, g, chip_run)
                  if form == "chip" else counts)
        floor = w * traffic_bytes(form, var, iters) / jump_cuda.HBM_RATE
        design_ms = max(probe_cuda.bound_ms(design, w * iters, 0)[0],
                        floor * 1e3)
        family = "inv_chip" if form == "chip" else "inv_chain"
        a = probe_cuda.attrs(family, var, g)
        if form == "chip" and a["local_bytes"]:
            raise RuntimeError(f"{name}: {a['local_bytes']} B of local "
                               f"memory a thread (the on-chip form keeps "
                               f"none)")
        if form == "chip" and var == "none":
            # the ALU-pipe share of its SASS at that pipe's rate
            a["sass_alu_per_lane"] = none_alu(trips, g)
            design_ms = max(design_ms, probe_cuda.bound_ms(
                {"alu": a["sass_alu_per_lane"]}, w * iters, 0)[0])
        below = nodiv.get((form, g)) if var == "cur" else None
        rows.append({"variant": name, "form": form,
                     "key": probe_cuda.kernel_key(family, var, g),
                     "group": g, "lanes": w, "ms": ms,
                     "shape": f"{w} lanes x {iters} iterations, G {g}",
                     "us_per_iter": ms * 1e3 / iters,
                     "ns_per_lane": ns,
                     "ns_per_lane_over_none": None if form not in none_ns
                     or var == "none" else ns - none_ns[form],
                     "inv_us": None if below is None
                     else (ms - below[0]) * 1e3 / iters,
                     "inv_ns_per_lane": None if below is None
                     else ns - below[1],
                     "traffic_floor_ms": floor * 1e3,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "design_bound_ms": design_ms, **a})
    if verbose:
        print(f"walk layout: {threads} threads; on-chip form: one wave of "
              f"resident blocks; iters: {iters}", flush=True)
        for r in rows:
            over = ("" if r["ns_per_lane_over_none"] is None
                    else f", {r['ns_per_lane_over_none']:.4f} over none")
            inv = ("" if r["inv_ns_per_lane"] is None else
                   f"; fe_inv (cur - nodiv) {r['inv_ns_per_lane']:.4f} "
                   f"ns/lane, {r['inv_us']:.2f} us/iter")
            print(f"{r['variant']:13s} {r['ms']:9.3f} ms   "
                  f"{r['us_per_iter']:8.2f} us/inv-iter   "
                  f"{r['ns_per_lane']:.4f} ns/lane{over}{inv}; G "
                  f"{r['group']}, {r['lanes']} lanes; bound "
                  f"{r['bound_ms']:.3f} ms ({r['bound_by']}), this design's "
                  f"{r['design_bound_ms']:.3f} ms (its traffic floor "
                  f"{r['traffic_floor_ms']:.3f} ms); {r['regs']} regs, "
                  f"{r['local_bytes']} B local, {r['smem']} B shared, "
                  f"{r['blocks_per_sm']} blocks/SM"
                  + (f"; SASS {r['sass_alu_per_lane']:.2f} ALU-pipe "
                     f"instructions a lane-iteration, the function "
                     f"{probe_cuda.inv_counts('none', r['group'])}"
                     if "sass_alu_per_lane" in r else ""), flush=True)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    w_log2 = int(argv[0]) if len(argv) > 0 else W_LOG2
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    common.header("pkinv", ["kt_inv_chain", "kt_inv_chip"])
    run(w_log2, iters, argv[2].split(",") if len(argv) > 2 else None)


if __name__ == "__main__":
    main()
