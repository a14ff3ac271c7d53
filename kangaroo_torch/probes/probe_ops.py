"""Raw instruction throughput of the card (`kt_raw_chain<Op, 4>`).

The counterpart of scripts/probe_ops.py: every iteration mixes the loop
index into the operands so the compiler cannot reassociate, hoist or
strength-reduce the chain, and each thread runs 4 independent chains
over 2^20 elements, so the measurement is throughput, not latency.  The
TPU's 5-op product split becomes the 32x32->64 multiply-add field.cuh is
built from (IMAD.WIDE.U32), split into its halves.  Each trip of a
chain's loop unrolls 32 iterations of the 4 chains (probes.cuh
RAW_TRIP), so that the loop's counter, compare and branch are paid once
a trip.  shr16's shift-and-add runs in three kernels of one function:
on the ALU pipe (LEA.HI, the design), with SHR16_MIX_CHAINS of the 4
chains on the multiply-add pipe (IMAD.HI, shr16_mix), all there
(shr16_hi): the rates of the two forms, and whether a split pays.

    python -m kangaroo_torch.probes.probe_ops

Each row prints the rate in the TPU script's op count, the rate of the
instruction it names beside the card's derived peak for that
instruction's pipe, that instruction's static count in the kernel's
SASS (a kernel whose SASS lacks any of them is a fault), the
instructions of one trip of its loop beside its bound's counts
(probe_cuda.RAW_COUNTS) and its share of that bound, and the SM clock
sampled while the rows ran.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import jump_cuda, probe_cuda
from ..ops.probe_ref import F32_OPS
from . import common

ELEMS = 1 << 20
ILP = 4
INNER = 1 << 17
OPS = ("u32_add", "u32_mul", "mask16", "shr16", "shr16_mix", "shr16_hi",
       "i32_mul", "f32_add", "f32_mul", "f32_fma", "wide")
# ops per iteration as scripts/probe_ops.py counts them
TPU_OPS = {"u32_add": 2, "u32_mul": 2, "mask16": 2, "shr16": 2,
           "shr16_mix": 2, "shr16_hi": 2, "i32_mul": 2, "f32_add": 2,
           "f32_mul": 2, "f32_fma": 3, "wide": 5}
# the peak each row's named instruction is read against (instructions
# a second): the multiply pipe, the fp32 pipe, or the ALU pipe (IADD3,
# LOP3 and LEA.HI issue there only); IMAD.WIDE and IMAD.HI take two
# slots of the multiply pipe; shr16's two forms together, LEA.HI at the
# ALU pipe's rate and IMAD.HI at half the multiply pipe's
PEAK = {"IADD3": probe_cuda.PEAK["alu"], "IMAD": probe_cuda.PEAK["imad"],
        "LOP3": probe_cuda.PEAK["alu"], "LEA.HI": probe_cuda.PEAK["alu"],
        "IMAD.HI": probe_cuda.PEAK["imad"] / 2,
        "LEA.HI+IMAD.HI": probe_cuda.PEAK["alu"]
        + probe_cuda.PEAK["imad"] / 2,
        "FADD": probe_cuda.PEAK["fp32"], "FMUL": probe_cuda.PEAK["fp32"],
        "FFMA": probe_cuda.PEAK["fp32"],
        "IMAD.WIDE.U32": probe_cuda.PEAK["imad"] / 2}
# IMADs an element-iteration of the rows whose chain is a plain 32-bit
# multiply-add (one slot each): their IMAD rate, read against IMAD_PEAK
IMAD_SLOTS = {"u32_mul": 1, "i32_mul": 1}


def inputs(op: str, n: int, dev) -> torch.Tensor:
    """The TPU script's inputs: u32 in [1, 2^16), f32 in [1, 2)."""
    rng = np.random.RandomState(0)
    if op in F32_OPS:
        return torch.from_numpy(
            rng.uniform(1.0, 2.0, n).astype(np.float32)).to(dev)
    return torch.from_numpy(rng.randint(1, 1 << 16, n).astype(np.int32)).to(
        dev)


def count_insn(counts: dict, op: str, ilp: int) -> int:
    """Static count in kt_raw_chain<op, ilp>'s SASS of the instructions
    the row measures; raises when any of them is missing (shr16_mix
    names two forms, its SASS must hold both)."""
    tag = f"kt_raw_chainILi{probe_cuda.RAW_OPS.index(op)}ELi{ilp}EE"
    forms = probe_cuda.RAW_SASS[op][1]
    if "+" in probe_cuda.RAW_SASS[op][0]:
        return sum(common.require_insn(counts, tag, (m,)) for m in forms)
    return common.require_insn(counts, tag, forms)


def _row(op: str, x, counts: dict, trips: dict) -> dict:
    ms = common.time_ms(lambda: probe_cuda.raw_chain(op, x, INNER, ILP))
    work = ELEMS * INNER
    insn, _, per_iter = probe_cuda.RAW_SASS[op]
    bound = probe_cuda.bound_ms(probe_cuda.RAW_COUNTS[op], work, 8 * ELEMS)
    return {"op": op, "key": probe_cuda.kernel_key("raw_chain", op, ILP),
            "ms": ms, "tops": work * TPU_OPS[op] / ms / 1e9,
            "shape": f"{ELEMS} elements x {INNER} iterations, ILP {ILP}",
            "insn": insn, "rate": work * per_iter / ms * 1e3,
            "peak": PEAK[insn],
            "imad_rate": work * IMAD_SLOTS.get(op, 0) / ms * 1e3,
            "sass_count": count_insn(counts, op, ILP),
            "trip": dict(common.kernel_sass(
                trips, f"kt_raw_chainILi{probe_cuda.RAW_OPS.index(op)}"
                f"ELi{ILP}EE")),
            "blocks_per_sm": probe_cuda.attrs("raw_chain", op,
                                              ILP)["blocks_per_sm"],
            "bound_ms": bound[0], "bound_by": bound[1],
            "share": bound[0] / ms}


def run(verbose: bool = True):
    """Time every row; returns the rows (rates in instructions/s)."""
    dev = common.require_card()
    counts = common.sass_counts()
    trips = common.loop_trips()
    rows = []
    with common.ClockSampler() as clk:
        for op in OPS:
            rows.append(_row(op, inputs(op, ELEMS, dev), counts, trips))
    for r in rows:
        r["clock"] = clk.summary()
    if verbose:
        print(f"elements: {ELEMS}, ILP {ILP}, iterations: {INNER}; "
              f"{clk.summary()}", flush=True)
        for r in rows:
            print(f"{r['op']:10s}: {r['tops']:8.3f} Tops/s ({r['ms']:.3f} "
                  f"ms); {r['insn']} {r['rate'] / 1e12:.3f}e12/s "
                  f"({100 * r['rate'] / r['peak']:.1f} % of the derived "
                  f"{r['peak'] / 1e12:.3f}e12/s), {r['sass_count']} in "
                  f"SASS; bound {r['bound_ms']:.3f} ms ({r['bound_by']}) of "
                  f"{probe_cuda.RAW_COUNTS[r['op']]} an element-iteration: "
                  f"{100 * r['share']:.1f} %; {r['blocks_per_sm']} "
                  f"blocks/SM; a trip of its loop {r['trip']}", flush=True)
        by = {r["op"]: r for r in rows}
        top = max((r for r in rows if r["imad_rate"]),
                  key=lambda r: r["imad_rate"])
        print(f"measured: IMAD {by['u32_mul']['rate']:.4g}/s, IMAD.WIDE.U32 "
              f"{by['wide']['rate']:.4g}/s, IADD3 "
              f"{by['u32_add']['rate']:.4g}/s, FFMA "
              f"{by['f32_fma']['rate']:.4g}/s, LEA.HI "
              f"{by['shr16']['rate']:.4g}/s, IMAD.HI "
              f"{by['shr16_hi']['rate']:.4g}/s; highest IMAD rate "
              f"{top['imad_rate']:.4g}/s ({top['op']}) against the derived "
              f"IMAD_PEAK {jump_cuda.IMAD_PEAK:.4g}/s", flush=True)
    return rows


def main(argv=None):
    common.header("probe_ops",
                  [f"kt_raw_chain<{probe_cuda.RAW_OPS.index(op)}, 4>"
                   for op in OPS])
    run()


if __name__ == "__main__":
    main()
