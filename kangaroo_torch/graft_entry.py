"""Entry points of the port for a compile check: one window of the walk
and a sharded dry run.

Counterpart of __graft_entry__.py.  entry() returns one window of the
jump step (the walk kernel, kt_jump_kernel<false>, on a card; its plain
version ops/jump_ref.py only when the caller asks for the CPU) with a
small example herd; dryrun_multichip() splits a herd into lane shards
over n devices (parallel/sharding.py) and walks one window on each.

The kernel walks whole blocks of jump_cuda.LANE_QUANTUM lanes.  A herd
of fewer lanes (the JAX shapes: 512 lanes, and 64 a device) walks on a
card as a copy widened to whole blocks with repeats of its own lanes,
whose outputs are dropped.  Lanes walk independently (the batched
inversion is exact whatever lanes share it), so the herd's lanes come
out as they would alone.

    python -m kangaroo_torch.graft_entry [-device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core import curve, herd
from .core.jumptable import create_jump_table
from .core.solver import resolve_device
from .ops import jump_cuda, jump_ref
from .parallel import sharding
from .utils.rng import MT19937

# the example herd of __graft_entry__.py:17-39
RANGE_POWER = 64
KEY = 0xC0FFEE123456789
DP_SIZE = 16
# entry()'s window (__graft_entry__.py:48-51) and the dry run's
# (__graft_entry__.py:86-93)
NB_RUN = 4
SLOTS = 2
DRY_NB_RUN = 2
DRY_LANES_PER_DEVICE = 64


def _example_inputs(n_lanes: int, seed: int = 1234, device="cuda"):
    """(px, py, d, jx, jy, jd, masks) of __graft_entry__._example_inputs
    as int32 limb tensors on `device`: a herd of n_lanes kangaroos (even
    lanes tame, odd wild) in a 2^64 range, the range's jump table and
    the masks of a 16-bit DP."""
    dev = resolve_device(str(device))
    px, py, d = herd.create_herd(
        n_lanes, RANGE_POWER, ((1 << RANGE_POWER) - 1) >> 1,
        curve.mul(KEY), 0, MT19937(seed), device=dev)
    jx, jy, jd = (torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in create_jump_table(RANGE_POWER).as_arrays())
    return px, py, d, jx, jy, jd, jump_ref.dp_limb_masks(DP_SIZE, dev)


def _whole_blocks(*tensors, quantum: Optional[int] = None) -> List:
    """Fresh copies of a herd's (rows, n) or (n,) tensors, widened to a
    multiple of `quantum` lanes (default: the kernel's lane quantum on a
    card, 1 on the CPU) with repeats of lanes 0, 1, ...; the window walks
    these, so the caller's tensors stay as they were."""
    n = tensors[0].shape[-1]
    if quantum is None:
        quantum = jump_cuda.LANE_QUANTUM if tensors[0].is_cuda else 1
    idx = torch.arange(-(-n // quantum) * quantum,
                       device=tensors[0].device) % n
    return [t[..., idx].contiguous() for t in tensors]


def _first_lanes(out: Sequence[torch.Tensor], n: int) -> tuple:
    """A window's outputs cut back to the herd's own n lanes."""
    return tuple(t[..., :n].contiguous() for t in out)


def entry(n_lanes: int = 512, device="cuda"):
    """(fn, example_args) for the single-card check.

    fn(px, py, d, jx, jy, jd, masks) is one window of NB_RUN jumps with
    SLOTS DP slots, jump_cuda.jump_steps_with_dp, and returns (px, py,
    d, count, dpx, dpd, step) with the contract of
    jump_ref.jump_steps_with_dp.  The JAX entry's inv_stop has no
    counterpart: the outputs are the same whatever the inversion's
    grouping.  On a card the kernel updates its herd in place; fn walks
    a copy (see _whole_blocks), so like the JAX fn it is pure: its
    arguments stay as they were and two calls on the same arguments give
    equal outputs.  The default device is the card; without one this
    raises (solver.resolve_device), and the CPU's plain walk runs only
    when device="cpu" is asked for."""
    args = _example_inputs(n_lanes, device=device)

    def fn(px, py, d, jx, jy, jd, masks):
        out = jump_cuda.jump_steps_with_dp(
            *_whole_blocks(px, py, d), jx, jy, jd, masks, nb_run=NB_RUN,
            slots=SLOTS)
        return _first_lanes(out, px.shape[1])

    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> List[tuple]:
    """One sharded window at the JAX dry run's shape: the herd of
    _example_inputs(64 * n_devices) in n_devices lane shards of 64 lanes
    (sharding.make_shards, each on its device with a stream of its own),
    the tables and masks replicated per device, and one window of
    DRY_NB_RUN jumps, SLOTS slots on every shard at once
    (sharding.make_sharded_jump_steps).

    `device` takes what sharding.resolve_devices takes: "cuda" (the
    first cards), "cpu" (n CPU shards) or a sequence of devices that may
    repeat a card, so that shards share it.  Fewer devices than
    n_devices raise RuntimeError, as the JAX function does; a card asked
    for and missing raises the solver's message.  Returns the shards'
    outputs in lane order, each (px, py, d, count, dpx, dpd, step) of
    its 64 lanes; raises unless every shard's px advanced."""
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip: n_devices must be >= 1, got "
                         f"{n_devices}")
    devices = sharding.resolve_devices(n_devices, device)
    if len(devices) < n_devices:
        raise RuntimeError(f"dryrun_multichip: need {n_devices} devices, "
                           f"have {len(devices)}")
    lanes = DRY_LANES_PER_DEVICE * n_devices
    px, py, d, jx, jy, jd, masks = _example_inputs(lanes, device=devices[0])
    shards = sharding.make_shards(devices, lanes)
    parts = sharding.shard_herd(shards, px, py, d)
    herds = []
    for s, (spx, spy, sd) in zip(shards, parts):
        with s.walk():  # made on the stream the shard's window runs on
            herds.append((*_whole_blocks(spx, spy, sd), None))
    tick = sharding.make_sharded_jump_steps(shards, DRY_NB_RUN, SLOTS)
    outs = tick(herds, sharding.replicate(shards, jx, jy, jd, masks))
    sharding.synchronize(shards)
    outs = [_first_lanes(o, s.hi - s.lo) for s, o in zip(shards, outs)]
    # the windows walked copies: parts still holds the positions before
    for i, (o, p) in enumerate(zip(outs, parts)):
        if torch.equal(o[0], p[0]):
            raise RuntimeError(f"dryrun_multichip: shard {i}'s positions "
                               f"did not advance")
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kangaroo_torch.graft_entry",
        description="Run entry()'s window, then one sharded window over "
                    "every available device; prints 'entry OK' and "
                    "'dryrun_multichip OK'.")
    ap.add_argument("-device", default="cuda",
                    help="cuda (default: every card), cuda:k or cpu")
    args = ap.parse_args(argv)
    fn, example = entry(device=args.device)
    out = fn(*example)
    if out[0].is_cuda:
        torch.cuda.synchronize(out[0].device)
    print("entry OK", flush=True)
    dryrun_multichip(len(sharding.resolve_devices(0, args.device)),
                     device=args.device)
    print("dryrun_multichip OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
