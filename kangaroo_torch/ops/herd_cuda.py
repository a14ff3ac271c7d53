"""The herd's start positions on the card: wrapper of the CUDA kernel
`csrc/herd_kernel.cu` (`kt_herd_kernel`, body in `csrc/herd.cuh`).

positions(mag, neg, wild, key_point, windows) is |d| G by byte windows,
negated (p - y) on `neg` lanes, plus keyToSearch on wild lanes: the
start of every kangaroo that `core.herd.herd_from_draws` makes, for a
search's herd, a batch key's and the solver's dead-lane resets.  Its
plain version, `positions_plain`, is the composition of `ec`'s batched
curve ops in PyTorch; a CPU tensor takes it, a CUDA tensor launches the
kernel or raises.

The kernel replaces no TPU kernel (the JAX package's k*G is XLA code).
What bounds it on an H100: a window is one affine add a lane, so the
function needs about the walk's `jump_cuda.imad_per_jump(n)` IMAD issue
slots per lane and window, and a key step more (`bound_ms`); its design
is the walk's, one safegcd inversion shared by a thread's G lanes, with
G picked here from the lane count (`group_for`) so that a small herd
still spreads over the SMs.  The generator table is uploaded to each
device once per process (`device_table`).
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core import curve
from ..utils.build import build_shared
from ..utils.intutils import int_to_limbs
from . import ec, jump_cuda

#: launches of the herd kernel in this process
LAUNCHES = 0

# Geometry (walk.cuh, herd.cuh): threads a block, the most lanes a
# thread takes (herd_args refuses more), words a table entry (x, then y)
THREADS = jump_cuda.THREADS
MAX_GROUP = 64
TABLE_WORDS = 16

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_devices = {}  # torch.device -> (table on it, its SM count)


def build() -> Path:
    """Build the kernel library (nvcc, sm_90a); returns its path."""
    return build_shared(
        "libkangaroo_herd.so",
        [_CSRC / "herd_kernel.cu"],
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
        deps=[_CSRC / "field.cuh", _CSRC / "walk.cuh", _CSRC / "herd.cuh"],
    )


def load() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.kt_herd_positions.restype = ctypes.c_int
            lib.kt_herd_positions.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 2)
            lib.kt_herd_error_string.restype = ctypes.c_char_p
            lib.kt_herd_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


@lru_cache(maxsize=1)
def table_words() -> np.ndarray:
    """The generator table (ec._gtable_np) as the kernel reads it:
    (32, 256, 16) int32 holding 32-bit words, entry [w][j] = x words
    0..7 then y words 0..7 of (j + 1) 2^(8w) G, one 64-byte run."""
    t = ec._gtable_np().astype(np.uint32)               # (32, 2, 16, 256)
    words = t[:, :, 0::2, :] | (t[:, :, 1::2, :] << 16)  # (32, 2, 8, 256)
    words = words.transpose(0, 3, 1, 2).reshape(32, 256, TABLE_WORDS)
    return np.ascontiguousarray(words).view(np.int32)


def device_table(device: torch.device):
    """(table, SM count) of `device`: the table is uploaded on the first
    call of the process for that device and kept; the upload is waited
    for, so that a launch on any stream may read it."""
    with _lock:
        got = _devices.get(device)
        if got is None:
            tbl = torch.from_numpy(table_words()).to(device)
            torch.cuda.current_stream(device).synchronize()
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
            got = _devices[device] = (tbl, sms)
        return got


def group_for(n: int, sms: int) -> int:
    """Lanes a thread for a launch of n lanes on a card of `sms` SMs:
    the largest power of two up to MAX_GROUP that still gives every SM
    a block of THREADS threads, else 1.  A 2^22-lane herd takes 64 (512
    blocks: one wave), a batch key's 8192 lanes 1 (64 blocks)."""
    g = MAX_GROUP
    while g > 1 and -(-n // (THREADS * g)) < sms:
        g //= 2
    return g


def adds_needed(mag: np.ndarray, wild: np.ndarray, windows: int) -> int:
    """Affine adds the positions of these lanes need: a lane's windows
    with a nonzero byte after its first (the first takes the table point
    into the identity), and the key step on wild lanes.  mag: (16, N)
    limbs of |d|; wild: (N,) bool."""
    mag = np.asarray(mag, dtype=np.int64)
    nonzero = sum(((mag[w // 2] >> (8 * (w % 2))) & 0xFF) != 0
                  for w in range(windows))
    return int(np.maximum(nonzero - 1, 0).sum()) + int(np.sum(wild))


def bound_ms(n: int, adds: int) -> float:
    """Least time for `adds` affine adds over a herd of n lanes on an
    H100 SXM (adds_needed), in ms: each needs the walk's
    imad_per_jump(n) IMAD issue slots (one inversion a window for the
    whole herd).  The inputs and outputs, (2 windows + 2 + 128) B a
    lane, take less at every shape the herd runs."""
    return adds * jump_cuda.imad_per_jump(n) / jump_cuda.IMAD_PEAK * 1e3


def positions_plain(mag: torch.Tensor, neg: torch.Tensor,
                    wild: torch.Tensor, key_point: Optional[curve.PointA],
                    windows: int):
    """The plain version of `positions`: ec.signed_mult_base over the
    `windows` bytes of |d|, then ec.add_point of keyToSearch, taken on
    wild lanes.  The key add runs with p_zero all False: a |d| = 0 lane
    (2^248 G, see signed_mult_base) adds the key like any other, as the
    reference's vector AddDirect only special-cases p1 == 0
    (SECP256K1.cpp:296-298).  The points are exact, so they equal the
    JAX package's 32-window d*G."""
    sx, sy, _ = ec.signed_mult_base(mag, neg, windows)
    if key_point is None:
        return sx, sy
    none = torch.zeros((mag.shape[1],), dtype=torch.bool, device=mag.device)
    ax, ay = ec.add_point(sx, sy, none, key_point)
    wm = wild[None, :]
    return torch.where(wm, ax, sx), torch.where(wm, ay, sy)


def check_args(mag: torch.Tensor, neg: torch.Tensor, wild: torch.Tensor,
               windows: int) -> int:
    """Check the arguments as the kernel takes them; returns n."""
    n = mag.shape[1] if mag.dim() == 2 else -1
    dev = mag.device
    for t, name, dtype, shape in ((mag, "mag", torch.int32, (16, n)),
                                  (neg, "neg", torch.bool, (n,)),
                                  (wild, "wild", torch.bool, (n,))):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: {dtype} on {dev} required, got "
                             f"{t.dtype} on {t.device}")
        if n < 1 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous {shape} with n >= 1 "
                             f"required, got {tuple(t.shape)}")
    if not 1 <= windows <= 32:
        raise ValueError(f"windows must be in [1, 32], got {windows}")
    return n


def key_words(key_point: Optional[curve.PointA]) -> Optional[np.ndarray]:
    """keyToSearch as the kernel takes it: 16 uint32 words (x, then y),
    or None for no key step."""
    if key_point is None:
        return None
    limbs = np.concatenate([int_to_limbs(key_point.x),
                            int_to_limbs(key_point.y)]).astype(np.uint32)
    return np.ascontiguousarray(limbs[0::2] | (limbs[1::2] << 16))


def positions(mag: torch.Tensor, neg: torch.Tensor, wild: torch.Tensor,
              key_point: Optional[curve.PointA], windows: int):
    """Start positions (px, py), canonical (16, N) int32 limbs, of lanes
    with |d| = mag ((16, N) int32 limbs below 2^(8 windows)), negated
    where neg, plus key_point (keyToSearch; None: at infinity, no key
    step) where wild ((N,) bool each).

    On a card: one launch of kt_herd_kernel on mag's device, made
    current for it, and its current stream; no synchronization, outputs
    allocated here.  On the CPU: positions_plain.
    """
    if not mag.is_cuda:
        return positions_plain(mag, neg, wild, key_point, windows)
    global LAUNCHES
    n = check_args(mag, neg, wild, windows)
    dev = mag.device
    table, sms = device_table(dev)
    px = torch.empty((16, n), dtype=torch.int32, device=dev)
    py = torch.empty_like(px)
    key = key_words(key_point)
    lib = load()
    with torch.cuda.device(dev):
        err = lib.kt_herd_positions(
            mag.data_ptr(), neg.data_ptr(), wild.data_ptr(),
            table.data_ptr(), px.data_ptr(), py.data_ptr(), n, windows,
            group_for(n, sms), None if key is None else key.ctypes.data,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"herd kernel launch failed: "
                           f"{lib.kt_herd_error_string(err).decode()}")
    LAUNCHES += 1
    return px, py
