"""Multi-device herds: contiguous lane shards, each on its own device
and stream.

Counterpart of kangaroo_tpu/parallel/sharding.py, which shards one
logical herd over the lane axis of a 1-D device mesh (shard_map) and
replicates the jump table and the DP masks.  Here a shard is a lane
range [lo, hi) of the herd on one device with a CUDA stream of its own,
which carries all of the shard's work: its launches, the compaction of
its DP slots (queued behind its last window of a tick, read from pinned
memory), its dead-lane resets and snapshots.  So the shards'
launches run at once, across cards, or side by side on one card when a
device list repeats it.  The hot loop has no collective: every shard's
DPs drain to the one host table with their global lane indices, so
walk order, lane parity (tame or wild) and the dead-lane resets are
those of one device.  On the CPU the shards are lane ranges that the
plain walk takes in turn, the counterpart of the JAX tests' 8-device
virtual CPU mesh.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops import compact_cuda, jump_cuda


@dataclass
class Shard:
    """Lanes [lo, hi) of the herd on `device`; the stream is None on the
    CPU.  `blocks` holds the shard's compaction buffers on a card
    (compact_blocks)."""
    lo: int
    hi: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"] = None
    blocks: Optional[compact_cuda.Blocks] = None

    def walk(self):
        """The shard's device and stream made current: all of the
        shard's work runs under it (a new thread starts on each device's
        default stream, so a reader thread enters it too)."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack


def resolve_devices(n_devices: int,
                    device: Union[str, torch.device, Sequence]
                    ) -> List[torch.device]:
    """The devices a herd may shard over, at most n_devices of them (0:
    all): on "cuda" the first cards, on "cpu" n_devices CPU shards (0:
    one), "cuda:k" that card alone; a sequence names the devices itself
    and may repeat one, so that two shards share a card.  A card that is
    asked for and missing raises (solver.resolve_device)."""
    from ..core.solver import resolve_device

    if isinstance(device, (list, tuple)):
        devs = [resolve_device(str(d)) for d in device]
    else:
        dev = resolve_device(str(device))
        if dev.type == "cpu":
            devs = [dev] * max(1, n_devices)
        elif dev.index is not None:
            devs = [dev]
        else:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    return devs[:n_devices] if n_devices > 0 else devs


def shard_count(n_avail: int, n_lanes: int, unit: int = 1) -> int:
    """The JAX solver's shard rule (kangaroo_tpu/core/solver.py:431-435)
    in units of `unit` lanes: at most the devices there are and the
    units, lowered until the shards tile the herd evenly.  The unit is
    the walk kernel's lane quantum on a card, 1 on the CPU."""
    units = n_lanes // unit
    nd = max(1, min(n_avail, units))
    while nd > 1 and units % nd:
        nd -= 1
    return nd


def make_shards(devices: Sequence[torch.device], n_lanes: int,
                unit: int = 1, lo: int = 0) -> List[Shard]:
    """Contiguous, equal shards of the n_lanes lanes from lane `lo` on
    (a process's part of a larger herd: parallel/multihost.py) over the
    first shard_count(...) devices, each with its own stream on a
    card."""
    nd = shard_count(len(devices), n_lanes, unit)
    size = n_lanes // nd
    return [Shard(lo + i * size, lo + (i + 1) * size, dev,
                  torch.cuda.Stream(dev) if dev.type == "cuda" else None)
            for i, dev in enumerate(devices[:nd])]


def shard_herd(shards: Sequence[Shard], *arrays) -> List[tuple]:
    """Split (rows, n) or (n,) arrays (numpy or tensors on any device)
    into the shards' lane ranges: one tuple per shard, its arrays
    contiguous int32 tensors on its device, made on its walk stream
    after the work that produced them and finished on return."""
    tensors = [a if isinstance(a, torch.Tensor)
               else torch.as_tensor(np.asarray(a, dtype=np.int32))
               for a in arrays]
    waits = {t.device: torch.cuda.current_stream(t.device)
             for t in tensors if t.is_cuda}
    out = []
    for s in shards:
        with s.walk():
            if s.stream is not None:
                for w in waits.values():
                    s.stream.wait_stream(w)
            out.append(tuple(
                t[..., s.lo:s.hi].to(s.device, torch.int32).contiguous()
                for t in tensors))
    synchronize(shards)
    return out


def gather_herd(shards: Sequence[Shard], parts: Sequence[tuple]) -> tuple:
    """The shards' arrays (one tuple per shard) concatenated in lane
    order on the first shard's device; one shard's are returned as they
    are."""
    if len(parts) == 1:
        return tuple(parts[0])
    synchronize(shards)
    dev = shards[0].device
    return tuple(torch.cat([p[k].to(dev) for p in parts], dim=-1)
                 for k in range(len(parts[0])))


def replicate(shards: Sequence[Shard], *tensors) -> List[tuple]:
    """One copy of the tensors (the jump table, the DP masks) on each
    shard's device, made once per device and finished on return."""
    copies = {}
    for s in shards:
        if s.device not in copies:
            copies[s.device] = tuple(t.to(s.device) for t in tensors)
    for dev in copies:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return [copies[s.device] for s in shards]


def synchronize(shards: Sequence[Shard]) -> None:
    """Wait for all work queued on the shards' streams."""
    for s in shards:
        if s.stream is not None:
            s.stream.synchronize()


def compact_blocks(shard: Shard, slots: int, windows: int, nb_run: int,
                   dp_size: int) -> None:
    """Give a card's shard its compaction buffers (`shard.blocks`, a
    compact_cuda.Blocks) for a tick of `windows` windows of nb_run steps,
    `slots` slots, at dp_size: made on the first call for the shape,
    before any launch of the loop (an allocation between two streams'
    launches keeps them from running at once), and kept across solve()
    calls; a new shape replaces them.  Nothing on the CPU."""
    if shard.stream is None:
        return
    n = shard.hi - shard.lo
    cap = compact_cuda.capacity(n, nb_run, windows, dp_size, slots)
    b = shard.blocks
    if b is None or b.key != (n, slots, windows, cap):
        shard.blocks = None  # the old pinned blocks go first
        shard.blocks = compact_cuda.Blocks(shard.device, n, slots, windows,
                                           cap)


def queue_compact(shard: Shard, wins, slots: int, nb_run: int):
    """Queue the compaction of a tick's windows (each (count, dpx, dpd,
    step), in launch order): on a card a compact_cuda.Queued, launched
    on the shard's stream behind its last window into `shard.blocks`
    (compact_blocks); on the CPU a compact_cuda.Plain."""
    if shard.stream is None:
        return compact_cuda.Plain(wins, slots, nb_run, shard.lo)
    if shard.blocks is None:
        raise ValueError("a card's shard needs compact_blocks before its "
                         "first queue_compact")
    with shard.walk():
        return shard.blocks.queue(wins, slots, nb_run, shard.lo)


# The solver looks this up here on every pull (shard.lo set), so that
# portbench/faults.py can wrap it: keep its four positional arguments.
def compact(shard: Shard, q, slots: int, nb_run: int):
    """One shard's DPs of a tick, read to the host from q, what
    `queue_compact` returned, after its wait().  Returns (lost, block):
    lost exact, block (m, 20) int32 of [x limbs 0..9 | d limbs 0..7 |
    step within the tick (window * nb_run + step) | global lane]."""
    return q.read()


def make_sharded_jump_steps(shards: Sequence[Shard], nb_run: int,
                            slots: int = 2, symmetry: bool = False):
    """The window over every shard: returns tick(herds, tables), where
    herds holds one (px, py, d, symclass or None) per shard and tables
    one (jx, jy, jd, dp_masks) per shard (`replicate`).  Each shard's
    window is one `jump_cuda.jump_steps_with_dp` on its stream, so the
    shards run at once; tick returns the per-shard outputs, each with the
    contract of `jump_ref.jump_steps_with_dp` and, concatenated in lane
    order, bit-equal to one window over the whole herd.  No collective:
    the shards are independent."""
    def tick(herds, tables):
        # every shard's outputs first: a device allocation between two
        # streams' launches would keep them from running at once
        bufs = []
        for s, h in zip(shards, herds):
            with s.walk():
                bufs.append(jump_cuda.window_buffers(
                    h[0].shape[1], slots, s.device) if s.stream else None)
        outs = []
        for s, h, t, b in zip(shards, herds, tables, bufs):
            with s.walk():
                outs.append(jump_cuda.jump_steps_with_dp(
                    h[0], h[1], h[2], *t, nb_run=nb_run, slots=slots,
                    symmetry=symmetry, symclass=h[3] if symmetry else None,
                    buffers=b))
        return outs

    return tick
