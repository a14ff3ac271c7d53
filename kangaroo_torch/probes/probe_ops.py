"""Raw instruction throughput of the card (`kt_raw_chain<Op, 4>`).

The counterpart of scripts/probe_ops.py: every iteration mixes the loop
index into the operands so the compiler cannot reassociate, hoist or
strength-reduce the chain, and each thread runs 4 independent chains
over 2^20 elements, so the measurement is throughput, not latency.  The
TPU's 5-op product split becomes the 32x32->64 multiply-add field.cuh is
built from (IMAD.WIDE.U32), split into its halves.

    python -m kangaroo_torch.probes.probe_ops

Each row prints the rate in the TPU script's op count, the rate of the
instruction it names beside the card's derived peak for that
instruction's pipe, that instruction's static count in the kernel's
SASS (a kernel whose SASS lacks it is a fault), and the instructions of
one trip of its loop, from which its bound's counts are read
(probe_cuda.RAW_COUNTS).
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
OPS = ("u32_add", "u32_mul", "mask16", "shr16", "i32_mul", "f32_add",
       "f32_mul", "f32_fma", "wide")
# ops per iteration as scripts/probe_ops.py counts them
TPU_OPS = {"u32_add": 2, "u32_mul": 2, "mask16": 2, "shr16": 2,
           "i32_mul": 2, "f32_add": 2, "f32_mul": 2, "f32_fma": 3,
           "wide": 5}
# the peak each row's named instruction is read against: the multiply
# pipe, the fp32 pipe, or the ALU pipe (IADD3, LOP3 and SHF issue there
# only)
PIPE = {"IADD3": "alu", "IMAD": "imad", "LOP3": "alu", "SHF": "alu",
        "FADD": "fp32", "FMUL": "fp32", "FFMA": "fp32",
        "IMAD.WIDE.U32": "imad"}


def inputs(op: str, n: int, dev) -> torch.Tensor:
    """The TPU script's inputs: u32 in [1, 2^16), f32 in [1, 2)."""
    rng = np.random.RandomState(0)
    if op in F32_OPS:
        return torch.from_numpy(
            rng.uniform(1.0, 2.0, n).astype(np.float32)).to(dev)
    return torch.from_numpy(rng.randint(1, 1 << 16, n).astype(np.int32)).to(
        dev)


def count_insn(counts: dict, op: str, ilp: int) -> int:
    """Static count in kt_raw_chain<op, ilp>'s SASS of the instruction
    the row measures; raises when there is none."""
    return common.require_insn(
        counts, f"kt_raw_chainILi{probe_cuda.RAW_OPS.index(op)}ELi{ilp}EE",
        probe_cuda.RAW_SASS[op][1])


def _row(op: str, x, counts: dict, trips: dict) -> dict:
    ms = common.time_ms(lambda: probe_cuda.raw_chain(op, x, INNER, ILP))
    work = ELEMS * INNER
    insn, _, per_iter = probe_cuda.RAW_SASS[op]
    bound = probe_cuda.bound_ms(probe_cuda.RAW_COUNTS[op], work, 8 * ELEMS)
    return {"op": op, "key": probe_cuda.kernel_key("raw_chain", op, ILP),
            "ms": ms, "tops": work * TPU_OPS[op] / ms / 1e9,
            "shape": f"{ELEMS} elements x {INNER} iterations, ILP {ILP}",
            "insn": insn, "rate": work * per_iter / ms * 1e3,
            "peak": probe_cuda.PEAK[PIPE[insn]],
            "sass_count": count_insn(counts, op, ILP),
            "trip": dict(common.kernel_sass(
                trips, f"kt_raw_chainILi{probe_cuda.RAW_OPS.index(op)}"
                f"ELi{ILP}EE")),
            "blocks_per_sm": probe_cuda.attrs("raw_chain", op,
                                              ILP)["blocks_per_sm"],
            "bound_ms": bound[0], "bound_by": bound[1]}


def run(verbose: bool = True):
    """Time every row; returns the rows (rates in instructions/s)."""
    dev = common.require_card()
    counts = common.sass_counts()
    trips = common.loop_trips()
    rows = []
    with common.ClockSampler() as clk:
        for op in OPS:
            rows.append(_row(op, inputs(op, ELEMS, dev), counts, trips))
    if verbose:
        print(f"elements: {ELEMS}, ILP {ILP}, iterations: {INNER}; "
              f"{clk.summary()}", flush=True)
        for r in rows:
            print(f"{r['op']:24s}: {r['tops']:8.3f} Tops/s ({r['ms']:.2f} "
                  f"ms); {r['insn']} {r['rate'] / 1e12:.3f}e12/s "
                  f"({100 * r['rate'] / r['peak']:.1f} % of the derived "
                  f"{r['peak'] / 1e12:.3f}e12/s), {r['sass_count']} in "
                  f"SASS; bound {r['bound_ms']:.2f} ms ({r['bound_by']}) of "
                  f"{probe_cuda.RAW_COUNTS[r['op']]} an element-iteration; "
                  f"{r['blocks_per_sm']} blocks/SM; a trip of its loop "
                  f"{r['trip']}", flush=True)
        by = {r["op"]: r for r in rows}
        print(f"measured: IMAD {by['u32_mul']['rate']:.4g}/s, IMAD.WIDE.U32 "
              f"{by['wide']['rate']:.4g}/s, IADD3 "
              f"{by['u32_add']['rate']:.4g}/s, FFMA "
              f"{by['f32_fma']['rate']:.4g}/s; derived IMAD_PEAK "
              f"{jump_cuda.IMAD_PEAK:.4g}/s", flush=True)
    return rows


def main(argv=None):
    common.header("probe_ops",
                  [f"kt_raw_chain<{i}, 4>" for i in range(len(OPS))])
    run()


if __name__ == "__main__":
    main()
