"""Weak-scaling harness: the herd's rate per device on 1..8 lane shards.

Counterpart of scripts/weak_scaling.py.  The herd is embarrassingly
parallel (one herd per GPU in the reference, Kangaroo.cpp:1041-1047), so
the only scaling threats are the cost of driving several shards and the
host-side DP drain against the device's ticks.  This harness walks the
SAME herd size per shard on 1, 2, 4 and 8 shards (parallel/sharding.py:
a lane range on a device with a stream of its own) and reports, per
shard count:

  - kernel seconds per tick: `reps` ticks of `nb_run` steps chained with
    no host work between them, after one tick that settles the build
    and the allocations; the host clock runs around
    sharding.synchronize, since each shard runs on its own stream
    (run_sizes(passes=P) times the sizes in P turns and takes each
    size's mean, so that on a host shared with other work every size
    samples the same stretch of time);
  - drain seconds per tick: the solver's own per-shard compaction of
    the last tick's DP slots (sharding.queue_compact, the wait for the
    shard's stream, sharding.compact: on a card the compaction kernels,
    their copy to pinned memory and its read; on the CPU the plain
    version), timed shard by shard after the kernel timing and one
    untimed compaction per shard (the first in a process loads its
    kernels); the slowest shard's seconds,
    with each shard's beside them (the quantity of the solver's
    stats.compact_s);
  - the rate (M jumps/s) in all and per shard, and the weak-scaling
    efficiency against the 1-shard rate.

Its inputs are the JAX script's: the jump table create_jump_table(64),
the DP masks at dp 16, and np.random.RandomState(99) drawing px, py (16
limbs) and d (8 limbs) per size, in its order.  The herd is random
limbs, not curve points: the walk's arithmetic does not care, and no
herd creation (k*G) enters the timing.  The walk is the plain one,
kt_jump_kernel<false> on a card (ops/jump_cuda.py), the plain PyTorch
walk (ops/jump_ref.py) on the CPU.

Devices: --device cuda gives one shard per card; cpu gives CPU shards,
the counterpart of the JAX script's forced 8-device CPU mesh; a list
such as cuda:0,cuda:0 puts several shards side by side on one card.
Sizes above the devices there are dropped.  Where the shards share
hardware (CPU shards, or shards side by side on one card) the rate per
shard falls with the shard count by construction: such a run checks the
harness's mechanics and the drain's cost, NOT hardware scaling, and the
payload says so in a caveat.  On two or more cards it is the scaling
measurement.

Defaults: on a card 2^22 lanes per shard (one wave of the walk kernel,
512 blocks of 128 threads x 64 lanes), 64 steps a tick, dp 16, 3 reps,
and the slot count the solver gives the window over the largest herd of
the run (core/solver.py slots_for_window), the same at every size; on
the CPU the JAX script's 2^10 lanes and 8 steps.

    python -m kangaroo_torch.parallel.weak_scaling [--out PATH]
        [--device cuda|cpu|cuda:0,cuda:0] [--sizes 1,2,4,8] [--lanes N]
        [--nb-run S] [--dp D] [--reps R]

writes the JSON payload (platform, note, results, and the caveat where
the shards share hardware) to --out (build/weak_scaling.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..core.jumptable import create_jump_table
from ..core.solver import slots_for_window
from ..ops import jump_cuda, jump_ref
from . import sharding

SEED = 99
RANGE_POWER = 64
DP_BITS = 16
SIZES = (1, 2, 4, 8)
CARD_LANES, CARD_NB_RUN = 1 << 22, 64
CPU_LANES, CPU_NB_RUN = 1 << 10, 8

NOTE = ("weak scaling: constant lanes/device; efficiency = per-device rate "
        "vs 1-device rate; drain overlaps compute in the production "
        "pipelined solver, reported separately")
CAVEAT_CPU = ("CPU shards share the same physical cores: per-device rate "
              "degrades with shard count by construction; this run "
              "validates harness mechanics + drain cost only, NOT hardware "
              "scaling")
CAVEAT_CARD = ("shards side by side on one card share its SMs: per-device "
               "rate degrades with shard count by construction; this run "
               "validates harness mechanics + drain cost only, NOT hardware "
               "scaling")


def jump_tables():
    """The JAX script's jump table (create_jump_table(64)) as (jx, jy,
    jd) limb arrays."""
    return create_jump_table(RANGE_POWER).as_arrays()


def draw_herd(rng, n):
    """One size's random herd, as the JAX script draws it: px, py (16,
    n) then d (8, n), uint32 limbs below 2^16."""
    return tuple(rng.randint(0, 1 << 16, size=(rows, n)).astype(np.uint32)
                 for rows in (16, 16, 8))


def resolve(device, sizes):
    """The shards' devices: "cpu" gives max(sizes) CPU shards, "cuda"
    every card, a list (or a comma-separated string) names them and may
    repeat a card.  A card asked for and missing raises."""
    if isinstance(device, str) and "," in device:
        device = device.split(",")
    n = max(sizes) if isinstance(device, str) and device == "cpu" else 0
    return sharding.resolve_devices(n, device)


def shares_hardware(devices, nd):
    """Whether the first nd shards share hardware: CPU shards, or a
    card that holds more than one of them."""
    devs = devices[:nd]
    return nd > 1 and (devs[0].type == "cpu" or len(set(devs)) < nd)


def run_sizes(sizes=None, lanes_per_dev=None, nb_run=None, reps=3,
              device="cuda", dp_bits=DP_BITS, slots=None, passes=1,
              on_first_tick=None):
    """Measure (kernel, drain) per tick on the given shard counts;
    returns (results, devices).  Every size's herd is drawn and walks
    its settling tick first; then the sizes' kernel times are taken in
    turns, `passes` times, and each size's mean over its passes counts
    (with several short passes, every size samples the same stretch of
    time: other work on a shared host then slows them alike).
    on_first_tick(nd, inputs, shards, outs), if given, sees each size's
    first (settling) tick: inputs the host arrays (px, py, d, jx, jy,
    jd, masks) it walked, outs each shard's outputs (the walk's
    contract), before the timed ticks go on from them."""
    sizes = tuple(sizes or SIZES)
    devices = resolve(device, sizes)
    cuda = devices[0].type == "cuda"
    lanes_per_dev = lanes_per_dev or (CARD_LANES if cuda else CPU_LANES)
    nb_run = nb_run or (CARD_NB_RUN if cuda else CPU_NB_RUN)
    unit = jump_cuda.LANE_QUANTUM if cuda else 1
    if lanes_per_dev % unit:
        raise ValueError(f"lanes per device must be a multiple of {unit} "
                         f"on a card, not {lanes_per_dev}")
    sizes = [s for s in sizes if s <= len(devices)]
    if not sizes:
        raise ValueError(f"no size fits the {len(devices)} devices")
    slots = slots or slots_for_window(nb_run, dp_bits,
                                      lanes_per_dev * max(sizes))

    jt = [a.astype(np.int32) for a in jump_tables()]
    masks = jump_ref.dp_limb_masks(dp_bits)
    rng = np.random.RandomState(SEED)
    runs = []
    for nd in sizes:
        shards = sharding.make_shards(devices[:nd], lanes_per_dev * nd, unit)
        assert len(shards) == nd, (len(shards), nd)
        px, py, d = draw_herd(rng, lanes_per_dev * nd)
        herds = [list(h) + [None]
                 for h in sharding.shard_herd(shards, px, py, d)]
        tables = sharding.replicate(
            shards, *(torch.from_numpy(a) for a in jt), masks)
        tick = sharding.make_sharded_jump_steps(shards, nb_run, slots)
        outs = tick(herds, tables)
        sharding.synchronize(shards)  # the build and allocations settle
        if on_first_tick is not None:
            on_first_tick(nd, (px, py, d, *jt, masks.numpy()), shards, outs)
        runs.append({"nd": nd, "shards": shards, "tick": tick,
                     "tables": tables, "cur": herds, "kernel": []})
        del px, py, d, herds, outs

    # kernel only: reps ticks with NO host work between them
    for _ in range(passes):
        for r in runs:
            t0 = time.perf_counter()
            cur = r["cur"]
            for _ in range(reps):
                outs = r["tick"](cur, r["tables"])
                cur = [list(o[:3]) + [None] for o in outs]
            sharding.synchronize(r["shards"])
            r["kernel"].append((time.perf_counter() - t0) / reps)
            r["cur"], r["outs"] = cur, outs

    results = []
    for r in runs:
        # drain: the solver's compaction of each shard's DP slots of the
        # last tick, at its actual hit rate
        nd, outs = r["nd"], r.pop("outs")
        for s in r["shards"]:
            sharding.compact_blocks(s, slots, 1, nb_run, dp_bits)

        def pull(s, o):
            q = sharding.queue_compact(s, [o[3:7]], slots, nb_run)
            sharding.synchronize([s])
            return sharding.compact(s, q, slots, nb_run)

        for s, o in zip(r["shards"], outs):  # loads the kernels
            pull(s, o)
        per = [0.0] * nd
        for _ in range(reps):
            for i, (s, o) in enumerate(zip(r["shards"], outs)):
                t = time.perf_counter()
                pull(s, o)
                per[i] += time.perf_counter() - t
        per = [x / reps for x in per]
        dps = sum(int(o[3].clamp(max=slots).sum()) for o in outs)
        lost = sum(int((o[3] - o[3].clamp(max=slots)).sum()) for o in outs)
        del outs, r["cur"]

        t_kernel = sum(r["kernel"]) / passes
        rate = lanes_per_dev * nd * nb_run / t_kernel / 1e6
        results.append({
            "devices": nd,
            "lanes_per_device": lanes_per_dev,
            "kernel_s_per_tick": round(t_kernel, 6),
            "drain_s_per_tick": round(max(per), 6),
            "mks": round(rate, 6),
            "mks_per_device": round(rate / nd, 6),
            "kernel_s_per_pass": [round(x, 6) for x in r["kernel"]],
            "drain_s_per_shard": [round(x, 6) for x in per],
            "dps_per_tick": dps,
            "lost_per_tick": lost,
            "nb_run": nb_run,
            "dp_bits": dp_bits,
            "slots": slots,
            "shared": shares_hardware(devices, nd),
        })
        print(results[-1], flush=True)

    base = results[0]["mks_per_device"]
    for r in results:
        r["weak_scaling_eff"] = round(r["mks_per_device"] / base, 4)
    return results, devices


def payload(results, devices):
    """The JAX script's JSON payload: platform, note, results, and a
    caveat where the shards share hardware."""
    cuda = devices[0].type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "device_name": (torch.cuda.get_device_name(devices[0]) if cuda
                           else "cpu"),
           "note": NOTE, "results": results}
    if not cuda:
        out["caveat"] = CAVEAT_CPU
    elif any(r["shared"] for r in results):
        out["caveat"] = CAVEAT_CARD
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build",
                                                  "weak_scaling.json"))
    ap.add_argument("--device", default="cuda",
                    help="cuda, cpu, or a list such as cuda:0,cuda:0")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--lanes", type=int, default=0,
                    help="lanes per shard (0: the device's default)")
    ap.add_argument("--nb-run", type=int, default=0,
                    help="steps a tick (0: the device's default)")
    ap.add_argument("--dp", type=int, default=DP_BITS)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    results, devices = run_sizes(
        [int(s) for s in a.sizes.split(",")], a.lanes or None,
        a.nb_run or None, a.reps, device=a.device, dp_bits=a.dp)
    out = payload(results, devices)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
