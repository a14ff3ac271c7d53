"""One shard's DP compaction of a tick on the card: wrapper of the CUDA
kernels `csrc/compact_kernel.cu` (`kt_compact_kernel`, body in
`csrc/compact.cuh`).

A tick's windows each leave a lane's DP count and its capture slots
(`jump_cuda.jump_steps_with_dp`); the compaction turns the occupied
slot cells, in the order window, slot, lane, into (m, 20) int32 records
[x limbs 0..9 | d limbs 0..7 | window * nb_run + step | lane + lo] and
counts the DPs beyond the slots (lost).  Its plain version,
`compact_plain`, is that computation in PyTorch ops; a CPU tensor takes
it, a CUDA tensor launches the kernels or raises.

On the card the solver queues a tick's compaction (`Blocks.queue`) on
the shard's stream right behind its last window: a count, a scan and a
gather launch write a header row (lost and m, exact int64) and the
first `capacity` records into a device block, and one copy and an
event bring the block to pinned host memory.  After `wait()`, `read()`
takes lost and the records from the pinned block; a tick with more
records than the capacity (a spill) has the rest gathered and copied
by one more launch and copy.  The capacity follows the shape
(`capacity`): the expected DPs and a margin that makes a spill
improbable.

The kernels replace no Pallas kernel: the JAX package compacts with the
XLA program `compact_fn` (kangaroo_tpu/core/solver.py).  What bounds
them on an H100 is bytes (`bound_ms`): the counts read, 76 B gathered
and 80 B written a record.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.build import build_shared
from . import jump_cuda, jump_ref

#: kt_compact calls (one a shard and tick) in this process
LAUNCHES = 0

# Geometry (compact.cuh): int32 a record and the header row, lanes a
# tile (one block of the count and gather kernels), the most slots
RECORD_WORDS = 20
TILE = 1024
MAX_SLOTS = 64

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def build() -> Path:
    """Build the kernel library (nvcc, sm_90a); returns its path."""
    return build_shared(
        "libkangaroo_compact.so",
        [_CSRC / "compact_kernel.cu"],
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
        deps=[_CSRC / "compact.cuh"],
    )


def load() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.kt_compact.restype = _I
            lib.kt_compact.argtypes = ([_P] * 4 + [_I] * 4
                                       + [_L, _P, _P, _L, _P, _P])
            lib.kt_compact_rest.restype = _I
            lib.kt_compact_rest.argtypes = ([_P] * 4 + [_I] * 4
                                            + [_L, _P, _L, _L, _P, _P])
            lib.kt_compact_error_string.restype = ctypes.c_char_p
            lib.kt_compact_error_string.argtypes = [_I]
            _lib = lib
        return _lib


def compact_plain(wins: Sequence[tuple], slots: int, nb_run: int,
                  lo: int = 0):
    """The plain version: a tick's windows, each (count, dpx, dpd, step)
    of n lanes on one device, compacted with PyTorch ops.  Occupied slot
    cells from each window's count; nonzero gives the exact hit count;
    the payload is gathered into one (m, 20) int32 block of [x limbs
    0..9 | d limbs 0..7 | step within the tick (window * nb_run + step)
    | lane + lo].  The lost count is exact: count - min(count, slots).
    Returns (lost, block)."""
    dev = wins[0][0].device
    m = wins[0][0].shape[0]
    slot_iota = torch.arange(slots, device=dev)[:, None]
    lost, blks = 0, []
    for w, (count, dpx, dpd, step) in enumerate(wins):
        c2 = torch.clamp(count, max=slots)
        lost = lost + (count - c2).sum()
        cells = (slot_iota < c2[None, :]).flatten().nonzero()
        cells = cells.squeeze(1)
        s_idx, lanes = cells // m, cells % m
        blks.append(torch.cat([
            dpx[s_idx, :, lanes], dpd[s_idx, :, lanes],
            (step[s_idx, lanes] + w * nb_run)[:, None],
            (lanes + lo)[:, None].to(torch.int32),
        ], dim=1))
    blk = blks[0] if len(blks) == 1 else torch.cat(blks)
    return int(lost), blk.cpu().numpy()


def capacity(n: int, nb_run: int, windows: int, dp_size: int,
             slots: int) -> int:
    """Records a tick's pinned block holds for n lanes: the expected DPs
    (n x nb_run x windows steps, one in 2^dp_size a DP) plus 8 standard
    deviations and 64, never more than the slot cells."""
    e = n * nb_run * windows / float(1 << dp_size)
    return min(slots * n * windows, math.ceil(e + 8.0 * math.sqrt(e) + 64))


def scratch_words(n: int, slots: int, windows: int) -> int:
    """int64 words of the scan's scratch (compact.cuh CompactArgs)."""
    return windows * -(-n // TILE) * (2 * slots + 1)


def bound_ms(n: int, windows: int, records: int) -> float:
    """Least time of a tick's compaction on an H100 SXM in ms, by bytes:
    each lane's count read once a window, and 76 B gathered and 80 B
    written a record (the scratch, 24 B a slot and 1024 lanes, left
    out)."""
    return (4 * n * windows + (76 + 80) * records) / jump_cuda.HBM_RATE * 1e3


def check_windows(wins: Sequence[tuple], slots: int) -> tuple:
    """Check a tick's windows as the kernels take them; returns (n,
    device)."""
    if not wins:
        raise ValueError("a tick has at least one window")
    if not 1 <= slots <= MAX_SLOTS:
        raise ValueError(f"slots must be in [1, {MAX_SLOTS}], got {slots}")
    n = wins[0][0].shape[0]
    dev = wins[0][0].device
    shapes = ((n,), (slots, jump_ref.DPX_ROWS, n), (slots, 8, n), (slots, n))
    for win in wins:
        for t, name, shape in zip(win, ("count", "dpx", "dpd", "step"),
                                  shapes):
            if (t.device != dev or t.dtype != torch.int32
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(
                    f"{name}: contiguous int32 {shape} on {dev} required, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return n, dev


def window_pointers(wins: Sequence[tuple]) -> list:
    """The four ctypes arrays of the windows' count, dpx, dpd and step
    pointers."""
    return [(_P * len(wins))(*(w[k].data_ptr() for w in wins))
            for k in range(4)]


class Blocks:
    """A shard's compaction buffers for one shape (n lanes, slots,
    windows a tick, capacity), made once and used tick after tick: the
    scan's scratch and a device block of 1 + capacity rows on the
    shard's device, and two pinned host blocks of as many rows that
    successive ticks take in turn, so that the host reads tick T-1's
    block while tick T's copy fills the other.  The device block and the
    scratch are read back (a spill) only before the next tick is
    queued, so one of each does."""

    def __init__(self, device: torch.device, n: int, slots: int,
                 windows: int, cap: int):
        self.key = (n, slots, windows, cap)
        self.device = device
        self.cap = cap
        self.scratch = torch.empty((scratch_words(n, slots, windows),),
                                   dtype=torch.int64, device=device)
        self.block = torch.empty((1 + cap, RECORD_WORDS), dtype=torch.int32,
                                 device=device)
        self.host = [torch.empty((1 + cap, RECORD_WORDS), dtype=torch.int32,
                                 pin_memory=True) for _ in range(2)]
        self.rows = [h.numpy() for h in self.host]
        self.turn = 0
        self.last = None  # the newest Queued: the scratch is its

    def queue(self, wins: Sequence[tuple], slots: int, nb_run: int,
              lo: int = 0) -> "Queued":
        """Launch the compaction of a tick's windows (count, dpx, dpd,
        step each) of this shape, and its copy to the next pinned
        block, then the event after it, on the device's current stream;
        no synchronization.  Returns the Queued tick."""
        global LAUNCHES
        n, dev = check_windows(wins, slots)
        if dev != self.device or (n, slots, len(wins)) != self.key[:3]:
            raise ValueError(f"windows of {n} lanes, {slots} slots, "
                             f"{len(wins)} windows on {dev}: these blocks "
                             f"take {self.key[:3]} on {self.device}")
        host, rows = self.host[self.turn], self.rows[self.turn]
        self.turn ^= 1
        stream = torch.cuda.current_stream(dev)
        q = Queued(self, list(wins), slots, nb_run, lo, rows, stream)
        lib = load()
        with torch.cuda.device(dev):
            err = lib.kt_compact(
                *q.ptrs, len(wins), n, slots, nb_run, lo,
                self.scratch.data_ptr(), self.block.data_ptr(), self.cap,
                host.data_ptr(), stream.cuda_stream)
        if err:
            raise RuntimeError(f"compaction kernel launch failed: "
                               f"{lib.kt_compact_error_string(err).decode()}")
        q.done = stream.record_event()
        LAUNCHES += 1
        self.last = q
        return q

    def rest(self, q: "Queued", r0: int, r1: int) -> np.ndarray:
        """Records of ranks [r0, r1) of q, the newest tick queued here,
        gathered and copied to the host (blocking) on q's stream."""
        if q is not self.last:
            raise RuntimeError("a spill is read only before the next tick "
                               "is queued on its blocks")
        out = torch.empty((r1 - r0, RECORD_WORDS), dtype=torch.int32,
                          device=self.device)
        lib = load()
        with torch.cuda.device(self.device), torch.cuda.stream(q.stream):
            err = lib.kt_compact_rest(
                *q.ptrs, len(q.wins), q.wins[0][0].shape[0], q.slots,
                q.nb_run, q.lo, self.scratch.data_ptr(), r0, r1,
                out.data_ptr(), q.stream.cuda_stream)
            if err:
                raise RuntimeError(
                    f"compaction kernel launch failed: "
                    f"{lib.kt_compact_error_string(err).decode()}")
            return out.cpu().numpy()


class Queued:
    """A tick's compaction on its way to the host: wait(), then read(),
    on any thread.  `spilled` tells whether the read needed the second
    copy."""

    def __init__(self, blocks: Blocks, wins: list, slots: int, nb_run: int,
                 lo: int, rows: np.ndarray, stream: "torch.cuda.Stream"):
        self.blocks = blocks
        self.wins = wins  # kept alive until read: a spill gathers again
        self.slots = slots
        self.nb_run = nb_run
        self.lo = lo
        self.rows = rows  # the pinned block, as numpy
        self.stream = stream
        self.ptrs = window_pointers(wins)
        self.spilled = False
        self.done = None  # the event after the copy (Blocks.queue)

    def wait(self) -> None:
        self.done.synchronize()

    def read(self):
        """(lost, block): block a (m, 20) int32 view of the pinned rows,
        valid until the tick after next is queued on the same blocks;
        with more than the capacity, a fresh array (the spill)."""
        return assemble(self.rows, self.blocks.cap, self._rest)

    def _rest(self, r0: int, r1: int) -> np.ndarray:
        self.spilled = True
        return self.blocks.rest(self, r0, r1)


class Plain:
    """A CPU shard's tick, with Queued's interface: compact_plain of its
    (wins, slots, nb_run, lo) when read; no wait, never a spill."""

    spilled = False

    def __init__(self, *args):
        self.args = args

    def wait(self) -> None:
        pass

    def read(self):
        return compact_plain(*self.args)


def assemble(rows: np.ndarray, cap: int, rest) -> tuple:
    """(lost, records) from a copied block of 1 + cap rows (the header,
    then the records of ranks below cap); rest(cap, m) gives the records
    of the ranks beyond it."""
    lost, m = (int(v) for v in rows[0, :4].view(np.int64))
    if m <= cap:
        return lost, rows[1:1 + m]
    return lost, np.concatenate([rows[1:], rest(cap, m)])

