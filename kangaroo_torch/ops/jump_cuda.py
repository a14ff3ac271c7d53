"""The walk on the card: wrapper of the CUDA kernel `csrc/jump_kernel.cu`.

Replaces the TPU kernel kangaroo_tpu/ops/jump_pallas.py:471
(`jump_steps_with_dp`: plain branch :378-403, slot capture :417-433,
symmetry branch :331-377, :406-415 and its epilogue :585-607) with one
hand-written CUDA C++ kernel for sm_90a in two instantiations, plain
and symmetry, built by nvcc at first use and bound with ctypes.

What bounds it on an H100.  The function needs ~832 32-bit integer
multiply-add issue slots per jump and next to no memory traffic: that
is its bound (`bound_ms`).  Per jump a lane needs 3 field multiplies of
Montgomery's trick (prefix product, two unwind steps), a multiply each
for lam and y3 and a squaring for lam^2, and a share of one safegcd
inversion (`INV_IMAD`: 20 batches of 30 divsteps, their 2x2 matrices
applied by 78 wide products a batch), which at least can be shared by
the whole herd: `imad_per_jump(n)`.  This design shares an inversion
among the G = 64 lanes of a thread and issues 874.4 slots per jump
(`imad_per_jump(GROUP)`, the design's count, not the bound), and its
own state traffic, `STATE_BYTES_PER_JUMP` = 256 B per lane and step, is
a floor (`design_traffic_ms`) above the bound.  What sets the time is
the issue of the multiply and carry chains (the probes price one field
multiply per lane at ~13 % of a step, the whole state traffic at ~17 %,
the inversion at ~4 %).  The design
  * inverts by safegcd (constant time, no divergence): 3160
    multiply-add slots against a Fermat chain's 25,680, and a dependent
    chain short enough to share over G = 64 lanes, so that 2^22 lanes
    make 65,536 threads;
  * runs THREADS x GROUP = 128 x 64 lanes per block, at most 128
    registers a thread (launch bounds: MIN_BLOCKS = 4 blocks per SM),
    i.e. 4 warps per scheduler and 2^22 lanes in one wave of 512
    blocks;
  * packs a window's state into 32-bit word scratch rows (x, y, d:
    `SCRATCH_ROWS` x n, allocated here) that the steps stream instead
    of the 16-bit limb rows: 256 B per lane and step, not 448;
  * keeps the jump table in shared memory (jmp differs across a warp,
    so constant memory would serialize) and a dedicated squaring (36
    wide products instead of 64).
The symmetry kernel normalizes each lane's class eagerly every step (no
multiply: a canonicalize, a compare, a conditional p - y and 128-bit
negate) and streams the lane's class as well, `SYM_STATE_BYTES` more
per lane and step.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version `jump_ref.jump_steps_with_dp`.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from ..utils.build import build_shared
from . import jump_ref

#: launches of the plain walk kernel in this process
LAUNCHES = 0
#: launches of the symmetry walk kernel in this process
SYM_LAUNCHES = 0

# Geometry of the kernels (THREADS threads x GROUP lanes per block,
# MIN_BLOCKS resident per SM by the launch bounds; walk.cuh); load()
# checks that the library was built with the same.  The window's packed
# state takes SCRATCH_ROWS 32-bit words per lane.
THREADS = 128
GROUP = 64
MIN_BLOCKS = 4
LANE_QUANTUM = THREADS * GROUP
SCRATCH_ROWS = 8 + 8 + 4
# Captured step indices ship to the host as uint16.
MAX_NB_RUN = 1 << 16

# IMAD issue slots per field multiply and squaring (field.cuh: 64 resp.
# 36 wide products + 8 in the reduction, a wide one counted as 2, plus
# ~4 for the folds), and per safegcd inversion (fe_inv: 20 batches, each
# applying its transition matrix to d, e (9 limbs x 4 wide products, and
# p's 3 nonzero limbs x 2) and to f, g (9 x 4), and 2 narrow products
# for the multiples of p: (78 x 2 + 2) x 20).
MUL_IMAD = 148
SQR_IMAD = 92
INV_IMAD = (78 * 2 + 2) * 20
# Peak 32-bit integer multiply-add rate of an H100 SXM, derived, not
# measured: half the FP32 FMA rate on compute capability 9.0 (64 vs 128
# per SM per clock), i.e. half of 67 TFLOP/s / 2 FLOP per FMA.
IMAD_PEAK = 67e12 / 2 / 2
HBM_RATE = 3.35e12  # bytes/s, H100 SXM data sheet
# Device-memory bytes this design moves per lane and step (walk.cuh):
# the forward pass reads x (32) and writes the prefix product (32), the
# backward pass reads x, y, d and the prefix product (112) and writes x,
# y, d (80); the symmetry kernel adds the lane's class, read in both
# passes and written in one.
STATE_BYTES_PER_JUMP = 256
SYM_STATE_BYTES = 12

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def imad_per_jump(group: int = GROUP) -> float:
    """IMAD issue slots per lane per jump when `group` lanes share one
    inversion, counted from the source: per group, G - 1 prefix and
    2 (G - 1) unwind multiplies and one inversion, and per lane a
    multiply each for lam and y3 and a squaring for lam^2.  At GROUP it
    is this design's count; at the herd's lane count it is the
    function's own need, which `bound_ms` takes.  The symmetry kernel's
    class normalization adds no multiply."""
    muls = 3 * (group - 1) + 2 * group
    return (muls * MUL_IMAD + group * SQR_IMAD + INV_IMAD) / group


def bound_ms(n: int, nb_run: int, slots: int, symmetry: bool = False,
             imad: Optional[float] = None) -> tuple:
    """Least time for one launch of n lanes x nb_run jumps on an H100
    SXM: (ms, "operations" or "bytes").  Both are the function's own
    need: imad_per_jump(n) slots per jump (one inversion a step for the
    whole herd), and the herd (and in symmetry mode the class row) read
    once, herd and slot outputs written once.  `imad` replaces
    imad_per_jump(n) for a variant of the walk (the probes)."""
    per_jump = imad_per_jump(n) if imad is None else imad
    ops_s = n * nb_run * per_jump / IMAD_PEAK
    sc = int(symmetry)
    rows_in = 16 + 16 + 8 + sc
    rows_out = 16 + 16 + 8 + sc + 1 + slots * (10 + 8 + 1)
    bytes_s = (rows_in + rows_out) * 4 * n / HBM_RATE
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def design_traffic_ms(n: int, nb_run: int, symmetry: bool = False) -> float:
    """The traffic floor of this design (not of the function): its
    per-step state streaming over the device-memory rate, in ms."""
    per = STATE_BYTES_PER_JUMP + (SYM_STATE_BYTES if symmetry else 0)
    return n * nb_run * per / HBM_RATE * 1e3


def build() -> Path:
    """Build the kernel library (nvcc, sm_90a); returns its path."""
    return build_shared(
        "libkangaroo_walk.so",
        [_CSRC / "jump_kernel.cu"],
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
        deps=[_CSRC / "field.cuh", _CSRC / "walk.cuh"],
    )


def load() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.kt_jump_steps.restype = ctypes.c_int
            lib.kt_jump_steps.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 7
            )
            lib.kt_walk_geometry.restype = None
            lib.kt_walk_geometry.argtypes = [ctypes.c_void_p]
            lib.kt_walk_occupancy.restype = ctypes.c_int
            lib.kt_walk_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
            lib.kt_error_string.restype = ctypes.c_char_p
            lib.kt_error_string.argtypes = [ctypes.c_int]
            geo = (ctypes.c_int * 4)()
            lib.kt_walk_geometry(geo)
            if tuple(geo) != (THREADS, GROUP, MIN_BLOCKS, SCRATCH_ROWS):
                raise RuntimeError("walk kernel geometry mismatch")
            _lib = lib
        return _lib


def occupancy(n: int, symmetry: bool = False, device=None) -> dict:
    """Registers and local bytes per thread, static shared bytes per
    block and resident blocks per SM of the plain or the symmetry walk
    kernel (kt_walk_occupancy) on `device` (default: the current card),
    and what they make of a launch of n lanes there: its blocks, whether
    they fit in one wave on the card's SMs, and the warps per scheduler
    (4 per SM) while it runs."""
    lib = load()
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        err = lib.kt_walk_occupancy(int(symmetry), out)
    if err:
        raise RuntimeError(f"walk kernel attributes: "
                           f"{lib.kt_error_string(err).decode()}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = n // LANE_QUANTUM
    resident = min(blocks, out[3] * sms)
    return {"regs": out[0], "local_bytes": out[1], "smem": out[2],
            "blocks_per_sm": out[3], "sms": sms, "blocks": blocks,
            "one_wave": blocks <= out[3] * sms,
            "warps_per_scheduler": resident * THREADS / 32 / (4 * sms)}


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device or t.dtype != torch.int32:
        raise ValueError(f"{name}: int32 on {device} required, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: contiguous {tuple(shape)} required, got "
                         f"{tuple(t.shape)}")


def check_walk_args(px, py, d, jx, jy, jd, dp_masks, nb_run: int,
                    slots: int, symclass: Optional[torch.Tensor] = None,
                    group: int = GROUP, alloc: bool = True):
    """Check a window's arguments as the walk kernels take them at G =
    group lanes per thread, and (with alloc) allocate its zeroed slot
    outputs; returns (count, dpx, dpd, step), or None without alloc."""
    n = px.shape[1]
    dev = px.device
    quantum = THREADS * group
    if n % quantum:
        raise ValueError(f"herd size {n} is not a multiple of the kernel's "
                         f"lane quantum {quantum}")
    if not 0 < nb_run < MAX_NB_RUN or slots < 1:
        raise ValueError(f"nb_run must be in [1, {MAX_NB_RUN}) and slots "
                         f">= 1, got {nb_run}, {slots}")
    checks = [
        (px, "px", (16, n)), (py, "py", (16, n)), (d, "d", (8, n)),
        (jx, "jx", (16, 32)), (jy, "jy", (16, 32)), (jd, "jd", (8, 32)),
        (dp_masks, "dp_masks", (4,)),
    ]
    if symclass is not None:
        checks.append((symclass, "symclass", (n,)))
    for t, name, shape in checks:
        _check(t, name, shape, dev)
    return _slot_outputs(n, slots, dev) if alloc else None


def _slot_outputs(n: int, slots: int, device) -> tuple:
    """A window's zeroed (count, dpx, dpd, step)."""
    z = dict(dtype=torch.int32, device=device)
    return (torch.zeros((n,), **z),
            torch.zeros((slots, jump_ref.DPX_ROWS, n), **z),
            torch.zeros((slots, 8, n), **z), torch.zeros((slots, n), **z))


def window_scratch(n: int, device) -> torch.Tensor:
    """The (SCRATCH_ROWS, n) words a window's state is packed into; the
    kernel writes every word before it reads it."""
    return torch.empty((SCRATCH_ROWS, n), dtype=torch.int32, device=device)


def window_buffers(n: int, slots: int, device) -> tuple:
    """A window's zeroed slot outputs (count, dpx, dpd, step) and its
    scratch, made ahead of the launch (`jump_steps_with_dp(buffers=)`):
    a device allocation issued between two streams' launches keeps them
    from running at once, so the sharded window allocates every shard's
    buffers before it launches any."""
    return _slot_outputs(n, slots, device) + (window_scratch(n, device),)


def jump_steps_with_dp(px, py, d, jx, jy, jd, dp_masks, nb_run: int = 16,
                       slots: int = 2, symmetry: bool = False,
                       symclass: Optional[torch.Tensor] = None,
                       buffers: Optional[tuple] = None):
    """nb_run jumps per lane; returns (px, py, d, count, dpx, dpd, step),
    and symclass last in symmetry mode.

    Same contract as `jump_ref.jump_steps_with_dp` (bit-equal px, d,
    count, DP slots and symclass; py equal mod p, and canonical in
    symmetry mode).  On the card the herd and the symmetry class
    (zeros when symclass is None) are updated IN PLACE: the returned
    px/py/d/symclass are the input tensors.  The slot outputs are fresh
    zeroed tensors, and the window's packed state goes to scratch,
    allocated here or taken from `buffers` (window_buffers: zeroed, of
    this window's lanes and slots, on px's device).  The launch goes on
    px's device, made current for it (the kernel launches on the calling
    thread's current device), and on that device's current stream; it
    does not synchronize.
    """
    if not px.is_cuda:
        return jump_ref.jump_steps_with_dp(
            px, py, d, jx, jy, jd, dp_masks, nb_run=nb_run, slots=slots,
            symmetry=symmetry, symclass=symclass,
        )
    global LAUNCHES, SYM_LAUNCHES
    n = px.shape[1]
    if symmetry and symclass is None:
        symclass = torch.zeros((n,), dtype=torch.int32, device=px.device)
    if buffers is None:
        count, dpx, dpd, step = check_walk_args(
            px, py, d, jx, jy, jd, dp_masks, nb_run, slots,
            symclass if symmetry else None)
        scratch = window_scratch(n, px.device)
    else:
        check_walk_args(px, py, d, jx, jy, jd, dp_masks, nb_run, slots,
                        symclass if symmetry else None, alloc=False)
        count, dpx, dpd, step, scratch = buffers
        for t, name, shape in (
                (count, "count", (n,)),
                (dpx, "dpx", (slots, jump_ref.DPX_ROWS, n)),
                (dpd, "dpd", (slots, 8, n)), (step, "step", (slots, n)),
                (scratch, "scratch", (SCRATCH_ROWS, n))):
            _check(t, name, shape, px.device)
    lib = load()
    with torch.cuda.device(px.device):
        err = lib.kt_jump_steps(
            px.data_ptr(), py.data_ptr(), d.data_ptr(), jx.data_ptr(),
            jy.data_ptr(), jd.data_ptr(), dp_masks.data_ptr(), n, nb_run,
            slots, count.data_ptr(), dpx.data_ptr(), dpd.data_ptr(),
            step.data_ptr(), symclass.data_ptr() if symmetry else None,
            scratch.data_ptr(),
            torch.cuda.current_stream(px.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"walk kernel launch failed: {lib.kt_error_string(err).decode()}"
        )
    if symmetry:
        SYM_LAUNCHES += 1
        return px, py, d, count, dpx, dpd, step, symclass
    LAUNCHES += 1
    return px, py, d, count, dpx, dpd, step
