"""The walk on the card: wrapper of the CUDA kernel `csrc/jump_kernel.cu`.

Replaces the TPU kernel kangaroo_tpu/ops/jump_pallas.py:471
(`jump_steps_with_dp`: plain branch :378-403, slot capture :417-433,
symmetry branch :331-377, :406-415 and its epilogue :585-607) with one
hand-written CUDA C++ kernel for sm_90a in two instantiations, plain
and symmetry, built by nvcc at first use and bound with ctypes.

What bounds it on an H100.  The function needs ~1030 32-bit integer
multiply-add issue slots per jump (`imad_per_jump`) and next to no
memory traffic: that is its bound.  Per jump a thread spends 5 field
multiplies (prefix product, two unwind steps, lam, y3) and 1 squaring
(lam^2) on its lane, plus 1/G of the Fermat inversion (255 squarings,
15 multiplies) it shares with its G lanes.  The design answers that by
sharing one inversion over G = 128 lanes per thread (Montgomery's
trick, the reference GPU kernel's grouped inverse and group size), a
dedicated squaring (36 wide products instead of 64), and a jump table
in shared memory (jmp differs across a warp, so constant memory would
serialize).  It pays for its simplicity in traffic: it re-streams the
limb state and the prefix products through device memory every step,
`STATE_BYTES_PER_JUMP` = 448 B per lane and step, a floor
(`design_traffic_ms`) above the multiply-add bound.  Holding the state
in registers across steps is later work.  The symmetry kernel
normalizes each lane's class eagerly every step (no multiply: a
canonicalize, a compare, a conditional p - y and 128-bit negate) and
streams the lane's class as well, `SYM_STATE_BYTES` more per lane and
step.

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

# Geometry of the kernel (THREADS threads x GROUP lanes per block,
# walk.cuh); the library reports its own and load() checks it.
THREADS = 128
GROUP = 128
LANE_QUANTUM = THREADS * GROUP
# Captured step indices ship to the host as uint16.
MAX_NB_RUN = 1 << 16

# IMAD issue slots per field multiply and squaring (field.cuh: 64 resp.
# 36 wide products + 8 in the reduction, a wide one counted as 2, plus
# ~4 for the folds), and the Fermat inversion's chain (fe_inv).
MUL_IMAD = 148
SQR_IMAD = 92
INV_SQRS, INV_MULS = 255, 15
# Peak 32-bit integer multiply-add rate of an H100 SXM, derived, not
# measured: half the FP32 FMA rate on compute capability 9.0 (64 vs 128
# per SM per clock), i.e. half of 67 TFLOP/s / 2 FLOP per FMA.
IMAD_PEAK = 67e12 / 2 / 2
HBM_RATE = 3.35e12  # bytes/s, H100 SXM data sheet
# Device-memory bytes this design moves per lane and step (walk.cuh),
# and what the symmetry kernel adds: the lane's class, read in both
# passes and written in one.
STATE_BYTES_PER_JUMP = 448
SYM_STATE_BYTES = 12

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def imad_per_jump() -> float:
    """IMAD issue slots per lane per jump, counted from the source: per
    group of G lanes, 3 (G - 1) prefix and unwind multiplies, one
    inversion, and per lane a multiply each for lam and y3 and a
    squaring for lam^2.  The symmetry kernel's class normalization
    adds no multiply."""
    muls = 3 * (GROUP - 1) + INV_MULS + 2 * GROUP
    sqrs = INV_SQRS + GROUP
    return (muls * MUL_IMAD + sqrs * SQR_IMAD) / GROUP


def bound_ms(n: int, nb_run: int, slots: int, symmetry: bool = False,
             imad: Optional[float] = None) -> tuple:
    """Least time for one launch of n lanes x nb_run jumps on an H100
    SXM: (ms, "operations" or "bytes").  The bytes are the function's own
    need: the herd (and in symmetry mode the class row) read once, herd
    and slot outputs written once.  `imad` replaces imad_per_jump() for a
    variant of the walk (the probes)."""
    per_jump = imad_per_jump() if imad is None else imad
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
            lib.kt_lane_quantum.restype = ctypes.c_int
            lib.kt_lane_quantum.argtypes = []
            lib.kt_jump_steps.restype = ctypes.c_int
            lib.kt_jump_steps.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 6
            )
            lib.kt_error_string.restype = ctypes.c_char_p
            lib.kt_error_string.argtypes = [ctypes.c_int]
            if lib.kt_lane_quantum() != LANE_QUANTUM:
                raise RuntimeError("walk kernel geometry mismatch")
            _lib = lib
        return _lib


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device or t.dtype != torch.int32:
        raise ValueError(f"{name}: int32 on {device} required, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: contiguous {tuple(shape)} required, got "
                         f"{tuple(t.shape)}")


def check_walk_args(px, py, d, jx, jy, jd, dp_masks, nb_run: int,
                    slots: int, symclass: Optional[torch.Tensor] = None):
    """Check a window's arguments as the walk kernels take them, and
    allocate its zeroed slot outputs; returns (count, dpx, dpd, step)."""
    n = px.shape[1]
    dev = px.device
    if n % LANE_QUANTUM:
        raise ValueError(f"herd size {n} is not a multiple of the kernel's "
                         f"lane quantum {LANE_QUANTUM}")
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
    count = torch.zeros((n,), dtype=torch.int32, device=dev)
    dpx = torch.zeros((slots, jump_ref.DPX_ROWS, n), dtype=torch.int32,
                      device=dev)
    dpd = torch.zeros((slots, 8, n), dtype=torch.int32, device=dev)
    step = torch.zeros((slots, n), dtype=torch.int32, device=dev)
    return count, dpx, dpd, step


def jump_steps_with_dp(px, py, d, jx, jy, jd, dp_masks, nb_run: int = 16,
                       slots: int = 2, symmetry: bool = False,
                       symclass: Optional[torch.Tensor] = None):
    """nb_run jumps per lane; returns (px, py, d, count, dpx, dpd, step),
    and symclass last in symmetry mode.

    Same contract as `jump_ref.jump_steps_with_dp` (bit-equal px, d,
    count, DP slots and symclass; py equal mod p, and canonical in
    symmetry mode).  On the card the herd and the symmetry class
    (zeros when symclass is None) are updated IN PLACE: the returned
    px/py/d/symclass are the input tensors.  The slot outputs are fresh
    zeroed tensors.  The launch goes on the current stream and does not
    synchronize.
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
    count, dpx, dpd, step = check_walk_args(
        px, py, d, jx, jy, jd, dp_masks, nb_run, slots,
        symclass if symmetry else None)
    lib = load()
    err = lib.kt_jump_steps(
        px.data_ptr(), py.data_ptr(), d.data_ptr(), jx.data_ptr(),
        jy.data_ptr(), jd.data_ptr(), dp_masks.data_ptr(), n, nb_run, slots,
        count.data_ptr(), dpx.data_ptr(), dpd.data_ptr(), step.data_ptr(),
        symclass.data_ptr() if symmetry else None,
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
