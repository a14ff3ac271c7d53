"""The kernels' own C++ bodies built for the CPU with g++.

`csrc/host_shim.cpp` compiles `field.cuh`, `walk.cuh`, `herd.cuh`,
`compact.cuh` and `probes.cuh` -- the code nvcc builds into the walk
kernel, the herd kernel, the compaction kernels and the probe kernels
-- for the host and exposes it through a plain C interface: the field
ops over arrays of 8-word elements, the walk kernel's, the herd
kernel's and the compaction kernels' launches run thread by thread
(`kt_walk_host`, `kt_herd_host`, `kt_compact_host`), and the probe
kernels' launches (`kt_*_host`).  `-check` runs the walk body through
it on the CPU, and the tests hold it against the JAX package and the
plain versions.  The library is built into `build/kangaroo_torch/` at
first use.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils.build import build_shared
from . import compact_cuda, herd_cuda, jump_cuda
from .probe_ref import (DELTA_VARIANTS, F32_OPS, FIELD_OPS, INV_VARIANTS,
                        RAW_OPS)

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

_SIGNATURES = {
    "kt_lane_quantum": ([], _I),
    "kt_fe_add_n": ([_P, _P, _P, _I], None),
    "kt_fe_sub_n": ([_P, _P, _P, _I], None),
    "kt_fe_mul_n": ([_P, _P, _P, _I], None),
    "kt_fe_sqr_n": ([_P, _P, _I], None),
    "kt_fe_inv_n": ([_P, _P, _I], None),
    "kt_fe_reduce512_n": ([_P, _P, _I], None),
    "kt_carry_op_n": ([_I] + [_P] * 4 + [_I], _I),
    "kt_add_u128_n": ([_P, _P, _I], None),
    "kt_fe_fold_n": ([_P, _P, _I], None),
    "kt_mulhi_add_n": ([_P] * 4 + [_I], None),
    "kt_xor3_n": ([_P] * 4 + [_I], None),
    "kt_fe_canon_n": ([_P, _I], None),
    "kt_fe_is_high_n": ([_P, _P, _I], None),
    "kt_fe_neg_n": ([_P, _P, _I], None),
    "kt_neg_u128_n": ([_P, _I], None),
    "kt_walk_host": ([_P] * 7 + [_I] * 3 + [_P] * 6, _I),
    "kt_herd_host": ([_P] * 6 + [_I] * 3 + [_P], _I),
    "kt_compact_host": ([_P] * 4 + [_I] * 4 + [_L, _P, _P, _L], _I),
    "kt_compact_rest_host": ([_P] * 4 + [_I] * 4 + [_L, _P, _L, _L, _P],
                             _I),
    "kt_field_chain_host": ([_I] + [_P] * 4 + [_I, _I], _I),
    "kt_raw_chain_host": ([_I, _I, _P, _I, _I], _I),
    "kt_delta_host": ([_I, _I] + [_P] * 7 + [_I] * 3 + [_P] * 5, _I),
    "kt_inv_chain_host": ([_I, _I, _P, _I, _I], _I),
    "kt_inv_chip_host": ([_I, _I, _P, _I, _I], _I),
    "kt_inv_chip_run_host": ([], _I),
}


def build() -> Path:
    """Build the host library (g++); returns its path."""
    return build_shared(
        "libkangaroo_host_shim.so", [_CSRC / "host_shim.cpp"],
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"],
        deps=[_CSRC / "field.cuh", _CSRC / "walk.cuh", _CSRC / "herd.cuh",
              _CSRC / "compact.cuh", _CSRC / "probes.cuh"],
        timeout=300,
    )


def load() -> ctypes.CDLL:
    """The host library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def call(name: str, *args) -> None:
    """lib.name(*args) for an entry point that returns 0 on success;
    raises ValueError when the body refuses its arguments."""
    rc = getattr(load(), name)(*args)
    if rc:
        raise ValueError(f"{name} refused its arguments (returned {rc})")


def walk(px, py, d, jx, jy, jd, dp_masks, nb_run: int = 16,
         slots: int = 2, symmetry: bool = False, symclass=None):
    """The walk kernel's body on the host, with the contract of
    `jump_cuda.jump_steps_with_dp` on contiguous int32 CPU tensors: the
    herd and the class (zeros when symclass is None) updated in place,
    fresh slot outputs; returns (px, py, d, count, dpx, dpd, step[,
    symclass])."""
    n = px.shape[1]
    if symmetry and symclass is None:
        symclass = torch.zeros(n, dtype=torch.int32)
    count, dpx, dpd, step = jump_cuda.check_walk_args(
        px, py, d, jx, jy, jd, dp_masks, nb_run, slots,
        symclass if symmetry else None)
    scratch = jump_cuda.window_scratch(n, px.device)
    call("kt_walk_host",
         *(t.data_ptr() for t in (px, py, d, jx, jy, jd, dp_masks)),
         n, nb_run, slots,
         *(t.data_ptr() for t in (count, dpx, dpd, step)),
         symclass.data_ptr() if symmetry else None, scratch.data_ptr())
    out = (px, py, d, count, dpx, dpd, step)
    return out + (symclass,) if symmetry else out


def herd_positions(mag, neg, wild, key_point, windows: int, group: int):
    """The herd kernel's body on the host at G = group lanes a thread,
    with the contract of `herd_cuda.positions` on CPU tensors; returns
    (px, py)."""
    n = herd_cuda.check_args(mag, neg, wild, windows)
    table = herd_cuda.table_words()
    key = herd_cuda.key_words(key_point)
    px = torch.empty((16, n), dtype=torch.int32)
    py = torch.empty_like(px)
    call("kt_herd_host", mag.data_ptr(), neg.data_ptr(), wild.data_ptr(),
         table.ctypes.data, px.data_ptr(), py.data_ptr(), n, windows, group,
         None if key is None else key.ctypes.data)
    return px, py


def compact(wins, slots: int, nb_run: int, lo: int = 0,
            cap: Optional[int] = None):
    """The compaction kernels' body on the host, with the contract of
    `compact_cuda.Queued.read` on a tick's CPU windows (count, dpx, dpd,
    step each): a block of 1 + cap rows (cap: every slot cell) is
    written as the card writes its device block, and the ranks beyond
    cap come from the spill's gather.  Returns (lost, block)."""
    n, _ = compact_cuda.check_windows(wins, slots)
    ptrs = compact_cuda.window_pointers(wins)
    cap = slots * n * len(wins) if cap is None else cap
    scratch = torch.empty(compact_cuda.scratch_words(n, slots, len(wins)),
                          dtype=torch.int64)
    rows = np.full((1 + cap, compact_cuda.RECORD_WORDS), -1, dtype=np.int32)
    args = (len(wins), n, slots, nb_run, lo, scratch.data_ptr())
    call("kt_compact_host", *ptrs, *args, rows.ctypes.data, cap)

    def rest(r0, r1):
        out = np.full((r1 - r0, compact_cuda.RECORD_WORDS), -1,
                      dtype=np.int32)
        call("kt_compact_rest_host", *ptrs, *args, r0, r1, out.ctypes.data)
        return out

    return compact_cuda.assemble(rows, cap, rest)


def to_words(limbs: torch.Tensor) -> np.ndarray:
    """(2k, N) int32 16-bit limbs -> (N, k) uint32 words (the layout of
    the kt_fe_*_n entry points)."""
    a = limbs.cpu().numpy().astype(np.uint32)
    return np.ascontiguousarray((a[0::2] | (a[1::2] << 16)).T)


def from_words(words: np.ndarray) -> torch.Tensor:
    """(N, k) uint32 words -> (2k, N) int32 limbs."""
    w = words.T
    out = np.empty((2 * w.shape[0], w.shape[1]), dtype=np.int32)
    out[0::2] = w & 0xFFFF
    out[1::2] = w >> 16
    return torch.from_numpy(out)


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """field.cuh's fe_mul on (16, N) limbs (relaxed result)."""
    wa, wb = to_words(a), to_words(b)
    r = np.empty_like(wa)
    load().kt_fe_mul_n(r.ctypes.data, wa.ctypes.data, wb.ctypes.data,
                       wa.shape[0])
    return from_words(r)


def fe_inv(a: torch.Tensor) -> torch.Tensor:
    """field.cuh's fe_inv (safegcd, canonical) on (16, N) limbs."""
    wa = to_words(a)
    r = np.empty_like(wa)
    load().kt_fe_inv_n(r.ctypes.data, wa.ctypes.data, wa.shape[0])
    return from_words(r)


def _words3(name: str, a, b, c) -> np.ndarray:
    """lib.name(r, a, b, c, n) on uint32 arrays of one shape; returns r."""
    a, b, c = (np.ascontiguousarray(v, dtype=np.uint32) for v in (a, b, c))
    if not a.shape == b.shape == c.shape:
        raise ValueError(f"shapes {a.shape}, {b.shape}, {c.shape} differ")
    r = np.empty_like(a)
    getattr(load(), name)(r.ctypes.data, a.ctypes.data, b.ctypes.data,
                          c.ctypes.data, a.size)
    return r


def mulhi_add(a, b, c) -> np.ndarray:
    """probes.cuh's mulhi_add, hi32(a * b) + c mod 2^32, elementwise (the
    host twin of the card's mad.hi.u32)."""
    return _words3("kt_mulhi_add_n", a, b, c)


def xor3(a, b, c) -> np.ndarray:
    """probes.cuh's xor3, a ^ b ^ c, elementwise (the host twin of the
    card's lop3.b32)."""
    return _words3("kt_xor3_n", a, b, c)


def _need(t: torch.Tensor, shape, dtype=torch.int32) -> None:
    """The native body reads `shape` elements of `dtype` from t."""
    if (t.device.type != "cpu" or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"contiguous {tuple(shape)} {dtype} on the CPU "
                         f"required, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def field_chain(op: str, x: torch.Tensor, b: torch.Tensor, rounds: int,
                jx=None, jy=None) -> torch.Tensor:
    """P1's body (probe_cuda.field_chain) on the host, x in place."""
    if op == "gather":
        jy = jx
    _need(x, (16, x.shape[1]))
    _need(b, x.shape)
    for t in (jx, jy):
        if t is not None:
            _need(t, (16, 32))
    call("kt_field_chain_host", FIELD_OPS.index(op), x.data_ptr(),
         b.data_ptr(), None if jx is None else jx.data_ptr(),
         None if jy is None else jy.data_ptr(), x.shape[1], rounds)
    return x


def raw_chain(op: str, x: torch.Tensor, inner: int,
              ilp: int = 4) -> torch.Tensor:
    """P2's body (probe_cuda.raw_chain) on the host, x in place."""
    _need(x, (x.numel(),),
          torch.float32 if op in F32_OPS else torch.int32)
    call("kt_raw_chain_host", RAW_OPS.index(op), ilp, x.data_ptr(),
         x.numel(), inner)
    return x


def delta_walk(variant: str, px, py, d, jx, jy, jd, dp_masks, nb_run: int,
               slots: int, group: int = jump_cuda.GROUP):
    """P3's body (probe_cuda.delta_walk) on the host at G = group, the
    herd in place; returns (px, py, d, count, dpx, dpd, step)."""
    count, dpx, dpd, step = jump_cuda.check_walk_args(
        px, py, d, jx, jy, jd, dp_masks, nb_run, slots, group=group)
    scratch = jump_cuda.window_scratch(px.shape[1], px.device)
    call("kt_delta_host", DELTA_VARIANTS.index(variant), group,
         *(t.data_ptr() for t in (px, py, d, jx, jy, jd, dp_masks)),
         px.shape[1], nb_run, slots,
         *(t.data_ptr() for t in (count, dpx, dpd, step)),
         scratch.data_ptr())
    return px, py, d, count, dpx, dpd, step


def inv_chain(variant: str, x: torch.Tensor, iters: int,
              group: int = jump_cuda.GROUP) -> torch.Tensor:
    """P4's body (probe_cuda.inv_chain) on the host, x in place."""
    _need(x, (16, x.shape[1]))
    call("kt_inv_chain_host", INV_VARIANTS.index(variant), group,
         x.data_ptr(), x.shape[1], iters)
    return x


def inv_chip(variant: str, x: torch.Tensor, iters: int,
             group: int) -> torch.Tensor:
    """P4's on-chip body (probe_cuda.inv_chip) on the host, x in place."""
    _need(x, (16, x.shape[1]))
    call("kt_inv_chip_host", INV_VARIANTS.index(variant), group,
         x.data_ptr(), x.shape[1], iters)
    return x


def chip_run() -> int:
    """Lanes of a run of the on-chip body (probes.cuh CHIP_RUN)."""
    return load().kt_inv_chip_run_host()
