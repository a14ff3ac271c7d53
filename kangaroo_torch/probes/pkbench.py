"""Per-op cost of the walk kernel's primitives on the card.

The counterpart of scripts/pkbench.py: one kernel per primitive chains
it `rounds` times with a data dependency (`kt_field_chain<Op>`), so the
per-op cost is measured as the card executes it.

    python -m kangaroo_torch.probes.pkbench [lanes_log2=22]

Rows: field.cuh's fe_mul, fe_sqr, fe_sub, fe_add, fe_fold (in place of
the TPU's 16-bit-limb carry pass `_carry_exact(16)`, which has no
32-bit-word counterpart), fe_canon, fe_inv (the safegcd inversion, the
counterpart of `modinv`, on every lane and on one block of 128 lanes:
its latency), the shared-memory table gather, a jump step without DP or
distance on the walk's geometry (G = 64 lanes per thread, one grouped
inversion), `batch_inv` as pkinv's `cur` at the walk's G, and the
production walk kernel (dp 20, 2 slots).  fe_mul and fe_sqr run once
more at the walk kernel's occupancy (its resident blocks per SM, read
from its attributes: 4 blocks of 128 threads, 4 warps per scheduler,
held there by dynamic shared memory, common.hold_to): their chains
alone need far fewer registers than the walk and run several times as
many warps.  The
default lane count is the walk's herd, so that the rows whose thread
owns G lanes run the walk's threads.  For the add-class carry chains
(fe_sub, fe_add, fe_fold) it counts the SASS instructions of a round
(one trip of the chain loop holds CHAIN_UNROLL rounds), all and those
of the ALU pipe, beside the slots their bound counts.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core.jumptable import create_jump_table
from ..ops import jump_cuda, jump_ref, probe_cuda
from ..ops.probe_ref import FIELD_OPS
from ..utils import sass
from . import common

LANES_LOG2 = 22
ROUNDS = {"mul": 256, "sqr": 256, "sub": 256, "add": 256, "fold": 256,
          "canon": 256, "inv": 16, "gather": 256, "step": 64}
INV_LANES = 128
# instruction classes counted in each chain's SASS, and the one each
# multiply or table row must hold
SASS_CLASSES = ("IMAD.WIDE", "IMAD", "IADD3", "LOP3", "LDS")
CLAIMS = {"mul": "IMAD.WIDE", "sqr": "IMAD.WIDE", "inv": "IMAD.WIDE",
          "gather": "LDS"}
BATCH_ITERS = 64
# rounds per trip of the add-class chains' loop on the card (probes.cuh
# CHAIN_UNROLL)
CHAIN_UNROLL = 4
CHAIN_OPS = ("sub", "add", "fold")
LABELS = {"mul": "mulmod (fe_mul)", "sqr": "sqrmod (fe_sqr)",
          "sub": "submod (fe_sub)", "add": "addmod (fe_add)",
          "fold": "fe_fold (for carry_exact)",
          "canon": "canonicalize (fe_canon)", "inv": "fe_inv (all lanes)",
          "gather": "gather (shared table)",
          "step": "jump step (no DP/dist)"}


def _row(label, key, ms, rounds, lanes, bound):
    return {"label": label, "key": key, "ms": ms, "rounds": rounds,
            "lanes": lanes, "shape": f"{lanes} lanes x {rounds} rounds",
            "us_per_op": ms * 1e3 / rounds,
            "mlane_ops": lanes * rounds / ms / 1e3, "bound_ms": bound[0],
            "bound_by": bound[1]}


def chain_sass() -> dict:
    """Per add-class op, the SASS of one trip of its chain loop in
    kt_field_chain<op> (the longest loop: CHAIN_UNROLL rounds, with the
    loop's counter, compare and branch): its instruction count, per
    round, those of the ALU pipe per round (the design's reading), its
    opcodes, every loop's length, and the bound's slots per round
    (probe_cuda.FIELD_COUNTS)."""
    funcs = sass.sass_functions(probe_cuda.build())
    out = {}
    for op in CHAIN_OPS:
        tag = f"kt_field_chainILi{FIELD_OPS.index(op)}EE"
        lines = common.kernel_sass(funcs, tag)
        loops = sass.loop_bodies(lines)
        if not loops:
            raise RuntimeError(f"{tag}: no loop in its SASS")
        trip = max(loops, key=len)
        ops = sass.opcode_counts(trip)
        alu = common.alu_count(ops)
        out[op] = {"trip": len(trip), "rounds": CHAIN_UNROLL,
                   "per_round": len(trip) / CHAIN_UNROLL,
                   "alu_per_round": alu / CHAIN_UNROLL,
                   "loops": [len(b) for b in loops],
                   "opcodes": dict(ops),
                   "bound_slots": sum(probe_cuda.FIELD_COUNTS[op].values())}
    return out


def inputs(n: int, dev):
    """The chains' random inputs: a, b (16, n) and the tables tbl (the
    gather's), jx, jy (16, 32)."""
    rng = np.random.RandomState(7)
    return tuple(common.limbs(rng, 16, w, dev) for w in (n, n, 32, 32, 32))


def tables(op: str, tbl, jx, jy):
    """The (jx, jy) arguments of op's chain."""
    return (tbl, None) if op == "gather" else (jx, jy)


def run(lanes_log2: int = LANES_LOG2, verbose: bool = True):
    """Time every row at 2^lanes_log2 lanes; returns the rows."""
    dev = common.require_card()
    counts = common.sass_counts()
    for op, insn in CLAIMS.items():
        common.require_insn(counts,
                            f"kt_field_chainILi{FIELD_OPS.index(op)}EE",
                            (insn,))
    chains = chain_sass()
    n = 1 << lanes_log2
    a, b, tbl, jx, jy = inputs(n, dev)
    rows = []
    for op in FIELD_OPS:
        r = ROUNDS[op]
        x = a.clone()
        tabs = tables(op, tbl, jx, jy)
        ms = common.time_ms(
            lambda: probe_cuda.field_chain(op, x, b, r, *tabs))
        bound = probe_cuda.bound_ms(probe_cuda.field_counts(op, n), n * r,
                                    3 * 64 * n)
        rows.append(_row(LABELS[op], probe_cuda.kernel_key("field_chain", op),
                         ms, r, n, bound))
        if op in chains:
            # this design's floor: its ALU-pipe instructions at that pipe
            rows[-1]["sass"] = chains[op]
            rows[-1]["design_bound_ms"] = probe_cuda.bound_ms(
                {"alu": chains[op]["alu_per_round"]}, n * r, 0)[0]
    # the multiply and the squaring at the walk kernel's occupancy (its
    # resident blocks per SM, held there by dynamic shared memory), where
    # the chains alone would run several times as many warps
    blocks = common.walk_blocks()
    for op in ("mul", "sqr"):
        x = a.clone()
        r = ROUNDS[op]
        smem = common.hold_to("field_chain", op, 0, blocks)
        ms = common.time_ms(lambda: probe_cuda.field_chain(
            op, x, b, r, smem=smem))
        rows.append(_row(f"{LABELS[op]} {common.walk_label(blocks)}",
                         probe_cuda.kernel_key("field_chain", op), ms, r, n,
                         probe_cuda.bound_ms(probe_cuda.field_counts(op, n),
                                             n * r, 3 * 64 * n)))
        rows[-1]["smem"] = smem
    # the inversion's latency: one block, one lane per thread
    x = a[:, :INV_LANES].contiguous()
    b1 = b[:, :INV_LANES].contiguous()
    r = ROUNDS["inv"]
    ms = common.time_ms(lambda: probe_cuda.field_chain("inv", x, b1, r))
    rows.append(_row(f"fe_inv ({INV_LANES} lanes)",
                     probe_cuda.kernel_key("field_chain", "inv"), ms, r,
                     INV_LANES, probe_cuda.bound_ms(
                         probe_cuda.field_counts("inv", INV_LANES),
                         INV_LANES * r,
                         3 * 64 * INV_LANES)))
    x = a.clone()
    ms = common.time_ms(
        lambda: probe_cuda.inv_chain("cur", x, BATCH_ITERS, probe_cuda.GROUP))
    g = probe_cuda.GROUP
    rows.append(_row(f"batch_inv (cur, G={g})",
                     probe_cuda.kernel_key("inv_chain", "cur", g), ms,
                     BATCH_ITERS, n, probe_cuda.bound_ms(
                         probe_cuda.inv_counts("cur", g), n * BATCH_ITERS,
                         2 * 64 * n)))
    tabs = [torch.from_numpy(t.astype(np.int32)).to(dev)
            for t in create_jump_table(64).as_arrays()]
    masks = jump_ref.dp_limb_masks(20, dev)
    state = (a.clone(), b.clone(),
             common.limbs(np.random.RandomState(8), 8, n, dev))
    steps = 256
    ms = common.time_ms(lambda: jump_cuda.jump_steps_with_dp(
        *state, *tabs, masks, nb_run=steps, slots=2))
    rows.append(_row("full kernel step", "walk/plain", ms, steps, n,
                     jump_cuda.bound_ms(n, steps, 2)))
    if verbose:
        print(f"lanes: {n}, rounds: {ROUNDS}", flush=True)
        for row in rows:
            print(f"{row['label']:26s} {row['us_per_op']:9.2f} us/op   "
                  f"({row['mlane_ops']:10.1f} Mlane-ops/s)   bound "
                  f"{row['bound_ms'] * 1e3 / row['rounds']:8.2f} us/op "
                  f"({row['bound_by']}); {row['ms']:.3f} ms/launch"
                  + (f", this design's ALU-pipe floor "
                     f"{row['design_bound_ms']:.3f} ms"
                     if "design_bound_ms" in row else ""), flush=True)
        for op in FIELD_OPS:
            c = common.kernel_sass(
                counts, f"kt_field_chainILi{FIELD_OPS.index(op)}EE")
            static = ", ".join(f"{m} {sass.count_class(c, m)}"
                               for m in SASS_CLASSES)
            print(f"  kt_field_chain<{op}>: "
                  f"{common.occupancy('field_chain', op)}; static SASS "
                  f"{static}; source count per round "
                  f"{probe_cuda.field_counts(op, n)}", flush=True)
        for op, c in chains.items():
            print(f"  kt_field_chain<{op}> SASS: {c['trip']} instructions "
                  f"a trip of {c['rounds']} rounds = {c['per_round']:.2f} "
                  f"per round (loop counter, compare and branch "
                  f"included; loops {c['loops']}) against the bound's "
                  f"{c['bound_slots']} slots; of the ALU pipe "
                  f"{c['alu_per_round']:.2f} per round (the design's "
                  f"floor at that pipe); opcodes of the trip "
                  f"{c['opcodes']}", flush=True)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    common.header("pkbench", ["kt_field_chain",
                              f"kt_inv_chain<0, {probe_cuda.GROUP}>"])
    run(int(argv[0]) if argv else LANES_LOG2)


if __name__ == "__main__":
    main()
