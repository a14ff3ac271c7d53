"""Cost attribution by variant deltas on the production walk kernel.

The counterpart of scripts/pkdelta.py: variants of the real jump kernel
with one component altered (`kt_delta_kernel<V, G>`, the production body
`walk_thread` with a variant type; `base` is the production code), timed
at the production shape, the cost of each component read from its delta
against `base`.

    python -m kangaroo_torch.probes.pkdelta [herd_log2=22] [nb_run=64] [variants]

Variants (pkdelta.py's default list): no_inv (dxi = dx: no prefix
products, no fe_inv), no_sqr, no_y3mul, extra_mul, extra_sub, no_dp and
fixed_gather (jmp = step & 31); and one Hopper variant, extra_traffic
(the forward pass reads each lane's y and writes it back unchanged: 128 B
more per lane and step and no arithmetic), which prices the state
traffic alone.  The TPU's inv_stop256/512 are pkinv's G sweep here;
extra_carry and the Mosaic-shape variants (extra_narrow9, extra_wide3,
extra_tree, extra_mulcols, raw_*) measure the TPU's 16-bit limb layout
and have no Hopper counterpart.  Geometry and capture as the solver runs
the walk: 128 threads x G = 64 lanes per block, 4 blocks per SM by the
launch bounds, dp 20 (pkdelta's), 6 slots.  The base also runs at G = 32
and 128 (`base@32`, `base@128`: the same launch bounds, 2^22 lanes in
1024 or 256 blocks), so that the choice of G is measured.
"""

from __future__ import annotations

import sys

import numpy as np

from ..ops import jump_cuda, jump_ref, probe_cuda
from ..ops.probe_ref import DELTA_VARIANTS
from . import common

HERD_LOG2 = 22
NB_RUN = 64
DP_SIZE = 20
SLOTS = 6


# base at the other G of the sweep, timed after the variants
SWEEP = [("base", g) for g in probe_cuda.DELTA_GROUPS["base"]
         if g != jump_cuda.GROUP]


def traffic_bytes(variant: str) -> int:
    """Device-memory bytes this design moves per lane and step
    (jump_cuda.STATE_BYTES_PER_JUMP); no_inv has no forward pass: no x
    read (32 B) there and no prefix product written and read (2 x 32 B);
    extra_traffic reads and writes the (16, n) y limb rows once more
    (2 x 64 B)."""
    full = jump_cuda.STATE_BYTES_PER_JUMP
    return full + {"no_inv": -96, "extra_traffic": 128}.get(variant, 0)


def parse(name: str):
    """'no_sqr' -> ('no_sqr', GROUP), 'base@32' -> ('base', 32)."""
    v, _, g = name.partition("@")
    return v, int(g) if g else jump_cuda.GROUP


def inputs(n: int, dev):
    """pkdelta.py's random state and tables (16-bit limbs)."""
    rng = np.random.RandomState(3)
    state = tuple(common.limbs(rng, rows, n, dev) for rows in (16, 16, 8))
    tabs = tuple(common.limbs(rng, rows, 32, dev) for rows in (16, 16, 8))
    return state, tabs


def run(herd_log2: int = HERD_LOG2, nb_run: int = NB_RUN, variants=None,
        verbose: bool = True):
    """Time base and each variant (names as `parse` reads them; by
    default every variant, then the G sweep), base again after each;
    returns the rows (a variant's delta in % of the two bases around
    it)."""
    dev = common.require_card()
    n = 1 << herd_log2
    state, tabs = inputs(n, dev)
    masks = jump_ref.dp_limb_masks(DP_SIZE, dev)
    names = variants or (list(DELTA_VARIANTS[1:])
                         + [f"{v}@{g}" for v, g in SWEEP])
    names = [v for v in names if parse(v) != ("base", jump_cuda.GROUP)]

    def timed(name):
        v, g = parse(name)
        st = [t.clone() for t in state]
        return common.time_ms(lambda: probe_cuda.delta_walk(
            v, *st, *tabs, masks, nb_run, SLOTS, g))

    # base runs before the first variant and after each one: a variant's
    # delta is against the mean of the two bases around it, and the
    # bases' spread is the run's noise
    bases = [timed("base")]
    times = {}
    for v in names:
        times[v] = timed(v)
        bases.append(timed("base"))
    base = sum(bases) / len(bases)
    rows = []
    for i, name in enumerate(["base"] + names):
        v, g = parse(name)
        ref = base if name == "base" else (bases[i - 1] + bases[i]) / 2
        ms = base if name == "base" else times[name]
        # the bound counts the variant's own need (one inversion a step
        # for the herd); this design's count shares it among G lanes
        imad = probe_cuda.delta_imad_per_jump(v, n)
        bound = jump_cuda.bound_ms(n, nb_run, SLOTS, imad=imad)
        floor = n * nb_run * traffic_bytes(v) / jump_cuda.HBM_RATE * 1e3
        rows.append({"variant": name, "group": g,
                     "key": probe_cuda.kernel_key("delta", v, g),
                     "ms": ms, "mks": n * nb_run / ms / 1e3,
                     "shape": f"{n} lanes x {nb_run} steps, dp {DP_SIZE}, "
                              f"{SLOTS} slots",
                     "delta_pct": (ms - ref) / ref * 100,
                     "imad_per_jump": imad,
                     "design_imad_per_jump":
                         probe_cuda.delta_imad_per_jump(v, g),
                     "traffic_floor_ms": floor,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     **probe_cuda.attrs("delta", v, g)})
    if verbose:
        print(f"herd: {n}, block: {jump_cuda.LANE_QUANTUM} lanes "
              f"({jump_cuda.THREADS} threads x {jump_cuda.GROUP}; the sweep "
              f"at G {[g for _, g in SWEEP]}), nb_run: "
              f"{nb_run}, dp {DP_SIZE}, {SLOTS} slots; base "
              f"{min(bases):.2f}-{max(bases):.2f} ms over {len(bases)} "
              f"readings ({(max(bases) - min(bases)) / base * 100:.1f} % "
              f"spread)", flush=True)
        for r in rows:
            d = ("" if r["variant"] == "base"
                 else f"  delta {r['delta_pct']:+6.1f}%")
            print(f"{r['variant']:14s} {r['ms']:8.2f} ms  {r['mks']:7.1f} "
                  f"MK/s{d}; bound {r['bound_ms']:.2f} ms "
                  f"({r['imad_per_jump']:.1f} IMAD/jump); this design's "
                  f"{r['design_imad_per_jump']:.1f} IMAD/jump at G "
                  f"{r['group']} and traffic floor "
                  f"{r['traffic_floor_ms']:.2f} ms; {r['regs']} regs, "
                  f"{r['local_bytes']} B local, {r['blocks_per_sm']} "
                  f"blocks/SM ({n // (jump_cuda.THREADS * r['group'])} "
                  f"blocks)", flush=True)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    herd = int(argv[0]) if len(argv) > 0 else HERD_LOG2
    nb_run = int(argv[1]) if len(argv) > 1 else NB_RUN
    common.header("pkdelta", ["kt_delta_kernel"])
    run(herd, nb_run, argv[2].split(",") if len(argv) > 2 else None)


if __name__ == "__main__":
    main()
