"""The probe kernels on the card: wrapper of `csrc/probe_kernels.cu`.

Replaces the repository's five TPU probe kernels with five hand-written
CUDA C++ kernel templates for sm_90a, built by nvcc at first use and
bound with ctypes:

  field_chain  P1 `kt_field_chain<Op>`, scripts/pkbench.py:62 run_chain;
  raw_chain    P2 `kt_raw_chain<Op, ILP>`, scripts/probe_ops.py:49 and
               scripts/layout_probe.py:109;
  delta_walk   P3 `kt_delta_kernel<V, G>`, scripts/pkdelta.py:213;
  inv_chain    P4 `kt_inv_chain<Var, G>`, scripts/pkinv.py:129, in the
               walk's layout;
  inv_chip     P4 `kt_inv_chip<Var, G>`, the same function with its state
               in shared memory for the whole launch (as the TPU kernel
               keeps its block in VMEM).

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version in `probe_ref`.  On the card the state tensor
is updated IN PLACE and returned (so that a timed launch is the launch
alone); the launch goes on the current stream and does not synchronize.
`LAUNCHES` counts the launches per kernel, keyed as `kernel_key` names
them.

What bounds each: `bound_ms` takes the slots per element and round of
each instruction class, counted from the source (`*_counts` below),
over the card's derived peak for that class, the slowest class and the
issue rate over them all, against the bytes the function moves (each
state array read and written once).
"""

from __future__ import annotations

import collections
import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..utils.build import build_shared_parts
from . import jump_cuda, probe_ref
from .probe_ref import (DELTA_VARIANTS, F32_OPS, FIELD_OPS, INV_VARIANTS,
                        RAW_OPS)

#: launches per kernel in this process, keyed by kernel_key()
LAUNCHES: Dict[str, int] = collections.Counter()

THREADS = jump_cuda.THREADS
GROUP = jump_cuda.GROUP
MIN_BLOCKS = jump_cuda.MIN_BLOCKS
LANE_QUANTUM = jump_cuda.LANE_QUANTUM
# (op, ILP) pairs of kt_raw_chain that probe_kernels.cu instantiates
RAW_ILPS = {op: (4,) for op in RAW_OPS}
RAW_ILPS["layout"] = (1, 2, 4, 16)
RAW_ILPS["empty"] = (1,)
# G of kt_inv_chain per variant
INV_GROUPS = {"cur": (32, 64, 128, 256), "nodiv": (32, 64, 128, 256),
              "none": (GROUP,)}
# G of kt_inv_chip, every variant: 2 and 1 resident blocks of cur and
# nodiv per SM by their shared memory, 4096 lanes an SM each time
CHIP_GROUPS = (16, 32)
# G of kt_delta_kernel per walk variant: base also at 32 and 128 (the G
# sweep), the others at the walk kernels' GROUP
DELTA_GROUPS = {v: (GROUP,) for v in DELTA_VARIANTS}
DELTA_GROUPS["base"] = (32, 64, 128)

# ---- the card's derived peaks (H100 SXM, compute capability 9.0) ----
# Per SM and clock (NVIDIA's arithmetic-throughput table for compute
# capability 9.0):
# 64 32-bit integer multiply-adds, 64 instructions of the ALU pipe, 128
# fp32 adds, multiplies and fused multiply-adds, 32 shared-memory words
# (loads and stores), and one warp instruction per scheduler and clock
# (128 thread instructions).  The counts are the function's need, each
# operation in the instruction forms the two integer pipes offer, by one
# rule: class "alu" holds logic ops and shifts (LOP3, SHF, LEA.HI: only
# the ALU pipe issues them); class "int" holds two-term integer adds and
# subtracts, with or without a carry (every word of a carry chain), and
# moves, which either pipe issues one for one (IADD3 and IADD3.X there,
# IMAD.IADD, IMAD.X and IMAD.MOV on the multiply-add pipe), so they
# count against the issue rate only: the best split of the two pipes;
# class "fused" holds an operation that one ALU-pipe instruction does at
# that pipe's rate (a three-term IADD3; a shift-and-add, LEA.HI, which
# probes/probe_ops.py's shr16 row times at the ALU pipe's rate) and
# that takes two slots otherwise (two adds; a shift and an add; IMAD.HI,
# which issues at half the IMAD rate: its shr16_hi row), at its best mix
# (bound_ms).  An instruction form that issues below its pipe's rate
# counts the pipe's slots it takes (IMAD.WIDE, IMAD.HI: two, class
# "imad2" where the function needs it) and one issue slot.  Where the
# function adds the loop index to a term (the probe_ops rows) the index
# is a value of its own each iteration, one add shared by a thread's ILP
# chains: 1/ILP "int" an element-iteration (the f32 rows' mix 1 + i *
# 1e-9 also a conversion, 1/ILP "int", and two fp32 ops); where it is
# xor-ed into a chain (layout) an unrolled trip folds it into the LOP3's
# immediate (probes.cuh raw_index) and it costs nothing.  The loop's
# own counter, compare and branch are this design's, once a trip, not
# counted (but for the empty loop, which is nothing else).  A row whose
# threads leave the schedulers short of warps (narrow1 and empty: 2^16
# threads, 3.9 warps a scheduler) is also bound by its dependent chain's
# latency, inner steps of the step's latency, read from the same chain
# at one warp a scheduler (probes/layout_probe.py's _lat rows): its
# bound is the larger of the two.  How many of a kernel's instructions
# nvcc puts on the ALU pipe is this design's reading, beside the bound
# (probes/pkbench.py, probes/pkinv.py, the raw chains' loop trips).  The
# clock is the one implied by jump_cuda.IMAD_PEAK (half the data sheet's
# 67 TFLOP/s fp32 rate over 64 x 132 SMs).  Derived, not measured: the
# raw_chain rows measure them.
SMS = 132
CLOCK_HZ = jump_cuda.IMAD_PEAK / (64 * SMS)
PER_SM_CLOCK = {"imad": 64, "alu": 64, "fp32": 128, "lds": 32,
                "issue": 128}
PEAK = {k: v * SMS * CLOCK_HZ for k, v in PER_SM_CLOCK.items()}

# Integer add, logic and shift instructions of one safegcd inversion,
# counted from field.cuh: 600 divsteps of ~27 (the sign and parity
# masks, three conditional negate-and-adds, the zeta update, three
# conditional adds, three shifts), and per batch 2 x 2 accumulators x 9
# limbs of a 64-bit shift pair and a mask.  Not split by kind: class
# "int" (the looser reading, a bound all the same).
INV_ALU = 20 * (30 * 27 + 4 * 9 * 4)
# Integer add instructions per op, counted from field.cuh at one
# instruction per word of a carry or borrow chain (the carry flag
# carries it), over the words each chain can reach: fe_sub the 8-word
# difference, an 8-word correction (its borrow can run to the top) and
# a second that ends at word 1 (it runs only from r >= 2^256 - K1C);
# fe_fold a first pass of 8 words and a second of 3 (after a carry out
# the low part is < 2^67), one wide multiply k * 977 (2 IMAD) and the
# carry's k2 * 977 (1); fe_add the 8-word sum, a fold of its carry over
# 8 words and of that pass's carry over 2 (the low part is < K1C), each
# carry times 977 one IMAD; fe_canon the 8-word carry chain of r +
# (2^32 + 977) (the copy only when it carries out).  Carry chains: class
# "int".  (nvcc puts the sub, add and fold chains' carries on the ALU
# pipe, 19, 17 and 10 instructions a round, and part of fe_canon's on the
# multiply-add pipe: the design's reading, probes/pkbench.py.)
SUB_INT = 18
CANON_INT = 8

FIELD_COUNTS = {
    "mul": {"imad": jump_cuda.MUL_IMAD},
    "sqr": {"imad": jump_cuda.SQR_IMAD},
    "sub": {"int": SUB_INT},
    "add": {"int": 18, "imad": 2},
    "fold": {"int": 11, "imad": 3},
    "canon": {"int": CANON_INT},
    "inv": {"imad": jump_cuda.INV_IMAD, "int": INV_ALU + 2 * CANON_INT},
    "gather": {"alu": 9, "lds": 8},   # index, 8 xors; 8 table words
}
# Slots per element and iteration (the peaks comment's rule); a 64-bit
# wide multiply-add one instruction of 2 IMAD slots ("imad2").
# RAW_PROBE_ILP: the ILP at which the probe_ops rows run, their index add
# shared by that many chains.
# u32_add: the xor and a + b + u (fused: one IADD3, or two adds).
# mask16 and shr16: a does not depend on b, so b's xors of two
# iterations fuse into one three-input LOP3 (1/2 an element-iteration);
# mask16's mask (a LOP3) and add; shr16's shift and add (fused: one
# LEA.HI, or two slots elsewhere).  i32_mul: the multiply-add and b's
# add.  f32: the row's two ops and b's add, and the mix.  wide: the
# wide multiply-add, the halves' add and the xor.  layout: the xor (one
# LOP3 with the index) and the multiply-add.  empty: the loop itself,
# a trip's counter add, compare, branch and x's add (the compilers add
# its RAW_TRIP ones at once) over RAW_TRIP iterations.
RAW_PROBE_ILP = 4
RAW_TRIP = 128  # probes.cuh RAW_TRIP
_IX = 1 / RAW_PROBE_ILP
RAW_COUNTS = {
    "u32_add": {"alu": 1, "fused": 1, "int": _IX},
    "u32_mul": {"imad": 1, "alu": 1, "int": _IX},
    "mask16": {"alu": 1.5, "int": 1 + _IX},
    "shr16": {"alu": 0.5, "fused": 1, "int": _IX},
    "i32_mul": {"imad": 1, "int": 1 + _IX},
    "f32_add": {"fp32": 3 + 2 * _IX, "int": 2 * _IX},
    "f32_mul": {"fp32": 3 + 2 * _IX, "int": 2 * _IX},
    "f32_fma": {"fp32": 3 + 2 * _IX, "int": 2 * _IX},
    "wide": {"imad2": 1, "int": 1 + _IX, "alu": 1},
    "layout": {"imad": 1, "alu": 1},
    "empty": {"int": 4 / RAW_TRIP},
}
# shr16's contrast rows hold its shift-and-adds to the forms they time:
# shr16_hi every one an IMAD.HI (two IMAD slots, "imad2"), shr16_mix
# SHR16_MIX_CHAINS = 1 of the 4 chains so and the others a LEA.HI (one
# ALU slot); their bounds count those forms, as wide_walk's its
# occupancy
RAW_COUNTS["shr16_hi"] = {"alu": 0.5, "imad2": 1, "int": _IX}
RAW_COUNTS["shr16_mix"] = {"alu": 0.5 + 3 * _IX, "imad2": _IX, "int": _IX}
# the instruction each raw row measures (the mnemonics nvcc may use for
# it), and how many of it one element-iteration issues; shr16_mix
# splits its shift-and-adds between two forms (probes.cuh
# SHR16_MIX_CHAINS of RAW_PROBE_ILP chains on IMAD.HI), each of which its
# SASS must hold
RAW_SASS = {
    "u32_add": ("IADD3", ("IADD3", "VIADD"), 1),
    "u32_mul": ("IMAD", ("IMAD",), 1),
    "mask16": ("LOP3", ("LOP3", "PRMT"), 1.5),
    "shr16": ("LEA.HI", ("LEA.HI",), 1),
    "shr16_mix": ("LEA.HI+IMAD.HI", ("LEA.HI", "IMAD.HI"), 1),
    "shr16_hi": ("IMAD.HI", ("IMAD.HI",), 1),
    "i32_mul": ("IMAD", ("IMAD",), 1),
    "f32_add": ("FADD", ("FADD",), 3),
    "f32_mul": ("FMUL", ("FMUL",), 1),
    "f32_fma": ("FFMA", ("FFMA",), 1),
    "wide": ("IMAD.WIDE.U32", ("IMAD.WIDE",), 1),
    "layout": ("IMAD", ("IMAD",), 1),
}

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def kernel_key(family: str, name: str, arg: int = 0) -> str:
    """The LAUNCHES key of a kernel: field_chain/<op>, raw_chain/<op>
    @ILP, delta/<variant>@G, inv_chain/<variant>@G, inv_chip/<variant>
    @G."""
    if family in ("raw_chain", "inv_chain", "inv_chip", "delta"):
        return f"{family}/{name}@{arg}"
    return f"{family}/{name}"


# the parts of probe_kernels.cu (its KT_PROBE_PART): the entry points
# with P1's light chains and P2, P1's fe_inv, P1's step, P4 in two, P3's
# walk variants in four, P4's on-chip form in two
BUILD_PARTS = 11


def build() -> Path:
    """Build the probe library (nvcc, sm_90a), its parts at once;
    returns its path."""
    return build_shared_parts(
        "libkangaroo_probes.so", _CSRC / "probe_kernels.cu",
        [[f"-DKT_PROBE_PART={i}"] for i in range(BUILD_PARTS)],
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
        ["nvcc", "-shared"],
        deps=[_CSRC / "field.cuh", _CSRC / "walk.cuh", _CSRC / "probes.cuh"],
    )


def load() -> ctypes.CDLL:
    """The probe library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            sigs = {
                "kt_probe_threads": ([], _I),
                "kt_probe_group": ([], _I),
                "kt_probe_min_blocks": ([], _I),
                "kt_field_chain_launch": ([_I] + [_P] * 4 + [_I] * 3 + [_P],
                                          _I),
                "kt_reduce512_launch": ([_P] * 3 + [_I, _P], _I),
                "kt_raw_chain_launch": ([_I, _I, _P, _I, _I, _I, _P], _I),
                "kt_delta_launch": ([_I, _I] + [_P] * 7 + [_I] * 3
                                    + [_P] * 6, _I),
                "kt_inv_chain_launch": ([_I, _I, _P, _I, _I, _P], _I),
                "kt_inv_chip_launch": ([_I, _I, _P, _I, _I, _P], _I),
                "kt_inv_chip_smem": ([_I, _I], _I),
                "kt_inv_chip_run": ([], _I),
                "kt_probe_attrs": ([_I, _I, _I, _I, _P], _I),
                "kt_probe_error_string": ([_I], ctypes.c_char_p),
            }
            for name, (args, res) in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            if (lib.kt_probe_threads(), lib.kt_probe_group(),
                    lib.kt_probe_min_blocks()) != (THREADS, GROUP,
                                                   MIN_BLOCKS):
                raise RuntimeError("probe kernel geometry mismatch")
            _lib = lib
        return _lib


def _raise(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.kt_probe_error_string(err).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: {dtype} on {device} required, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: contiguous {tuple(shape)} required, got "
                         f"{tuple(t.shape)}")


def field_chain(op: str, x: torch.Tensor, b: torch.Tensor, rounds: int,
                jx: Optional[torch.Tensor] = None,
                jy: Optional[torch.Tensor] = None,
                smem: int = 0) -> torch.Tensor:
    """P1: `rounds` rounds of op on x (16, n) with b fixed (see
    probe_ref.field_chain).  n is a multiple of THREADS, of LANE_QUANTUM
    for the step; the gather needs jx, the step jx and jy ((16, 32));
    `smem` bytes of dynamic shared memory per block hold the occupancy
    down."""
    if not x.is_cuda:
        return probe_ref.field_chain(op, x, b, rounds, jx, jy)
    if op not in FIELD_OPS:
        raise ValueError(f"unknown field op {op!r}")
    n = x.shape[1]
    quantum = LANE_QUANTUM if op == "step" else THREADS
    if n % quantum:
        raise ValueError(f"{n} lanes is not a multiple of {quantum}")
    dev = x.device
    _need(x, "x", torch.int32, (16, n), dev)
    _need(b, "b", torch.int32, (16, n), dev)
    if op == "gather":
        jy = jx
    tabs = (jx, jy) if op in ("gather", "step") else (None, None)
    for t, name in zip(tabs, ("jx", "jy")):
        if t is not None:
            _need(t, name, torch.int32, (16, 32), dev)
        elif op in ("gather", "step"):
            raise ValueError(f"{op} needs the table {name}")
    lib = load()
    _raise(lib, lib.kt_field_chain_launch(
        FIELD_OPS.index(op), x.data_ptr(), b.data_ptr(),
        *(None if t is None else t.data_ptr() for t in tabs), n, rounds,
        smem, _stream(x)), f"field chain {op}")
    LAUNCHES[kernel_key("field_chain", op)] += 1
    return x


def reduce512(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """field.cuh's fe_reduce512 on lo + hi * 2^256 ((16, n) int32 limbs
    each): (16, n) limbs of a relaxed value congruent to it mod p (see
    probe_ref.reduce512)."""
    if not lo.is_cuda:
        return probe_ref.reduce512(lo, hi)
    n = lo.shape[1]
    _need(lo, "lo", torch.int32, (16, n), lo.device)
    _need(hi, "hi", torch.int32, (16, n), lo.device)
    r = torch.empty_like(lo)
    lib = load()
    _raise(lib, lib.kt_reduce512_launch(r.data_ptr(), lo.data_ptr(),
                                        hi.data_ptr(), n, _stream(lo)),
           "reduce512")
    LAUNCHES["reduce512"] += 1
    return r


def raw_chain(op: str, x: torch.Tensor, inner: int, ilp: int = 4,
              smem: int = 0) -> torch.Tensor:
    """P2: `inner` iterations of op on every element of x ((E,) int32,
    float32 for the f32 ops), ILP chains per thread, `smem` bytes of
    dynamic shared memory per block to hold the occupancy down (see
    probe_ref.raw_chain)."""
    if not x.is_cuda:
        return probe_ref.raw_chain(op, x, inner)
    if op not in RAW_OPS or ilp not in RAW_ILPS[op]:
        raise ValueError(f"no raw chain {op!r} at ILP {ilp}")
    dtype = torch.float32 if op in F32_OPS else torch.int32
    _need(x, "x", dtype, (x.numel(),), x.device)
    if x.numel() % ilp:
        raise ValueError(f"{x.numel()} elements is not a multiple of {ilp}")
    lib = load()
    _raise(lib, lib.kt_raw_chain_launch(
        RAW_OPS.index(op), ilp, x.data_ptr(), x.numel(), inner, smem,
        _stream(x)), f"raw chain {op}")
    LAUNCHES[kernel_key("raw_chain", op, ilp)] += 1
    return x


def delta_walk(variant: str, px, py, d, jx, jy, jd, dp_masks, nb_run: int,
               slots: int, group: int = GROUP):
    """P3: one window of walk variant `variant` at G = group lanes per
    thread (DELTA_GROUPS); same contract as jump_cuda.jump_steps_with_dp
    in plain mode (the herd updated in place, fresh slot outputs).  The
    plain version does not depend on G."""
    if not px.is_cuda:
        return probe_ref.delta_walk(variant, px, py, d, jx, jy, jd,
                                    dp_masks, nb_run, slots)
    if variant not in DELTA_VARIANTS or group not in DELTA_GROUPS[variant]:
        raise ValueError(f"no walk variant {variant!r} at G = {group}")
    count, dpx, dpd, step = jump_cuda.check_walk_args(
        px, py, d, jx, jy, jd, dp_masks, nb_run, slots, group=group)
    scratch = jump_cuda.window_scratch(px.shape[1], px.device)
    lib = load()
    _raise(lib, lib.kt_delta_launch(
        DELTA_VARIANTS.index(variant), group,
        *(t.data_ptr() for t in (px, py, d, jx, jy, jd, dp_masks)),
        px.shape[1], nb_run, slots,
        *(t.data_ptr() for t in (count, dpx, dpd, step)),
        scratch.data_ptr(), _stream(px)), f"walk variant {variant}")
    LAUNCHES[kernel_key("delta", variant, group)] += 1
    return px, py, d, count, dpx, dpd, step


def inv_chain(variant: str, x: torch.Tensor, iters: int,
              group: int = GROUP) -> torch.Tensor:
    """P4: `iters` rounds of x <- canon(fn(x) - x) | 1 on x (16, n), n a
    multiple of THREADS * group (see probe_ref.inv_chain)."""
    if not x.is_cuda:
        return probe_ref.inv_chain(variant, x, iters, group)
    if variant not in INV_VARIANTS or group not in INV_GROUPS[variant]:
        raise ValueError(f"no inversion chain {variant!r} at G = {group}")
    n = x.shape[1]
    if n % (THREADS * group):
        raise ValueError(f"{n} lanes is not a multiple of {THREADS} x "
                         f"{group}")
    _need(x, "x", torch.int32, (16, n), x.device)
    lib = load()
    _raise(lib, lib.kt_inv_chain_launch(
        INV_VARIANTS.index(variant), group, x.data_ptr(), n, iters,
        _stream(x)), f"inversion chain {variant}")
    LAUNCHES[kernel_key("inv_chain", variant, group)] += 1
    return x


def inv_chip(variant: str, x: torch.Tensor, iters: int,
             group: int) -> torch.Tensor:
    """P4's on-chip form: what inv_chain computes at G = group (the same
    lane sets), with each thread's G lanes and prefix products in shared
    memory for the whole launch; n a multiple of THREADS * group, group
    in CHIP_GROUPS."""
    if not x.is_cuda:
        return probe_ref.inv_chain(variant, x, iters, group)
    if variant not in INV_VARIANTS or group not in CHIP_GROUPS:
        raise ValueError(f"no on-chip inversion chain {variant!r} at "
                         f"G = {group}")
    n = x.shape[1]
    if n % (THREADS * group):
        raise ValueError(f"{n} lanes is not a multiple of {THREADS} x "
                         f"{group}")
    _need(x, "x", torch.int32, (16, n), x.device)
    lib = load()
    _raise(lib, lib.kt_inv_chip_launch(
        INV_VARIANTS.index(variant), group, x.data_ptr(), n, iters,
        _stream(x)), f"on-chip inversion chain {variant}")
    LAUNCHES[kernel_key("inv_chip", variant, group)] += 1
    return x


def inv_chip_smem(variant: str, group: int) -> int:
    """Shared memory per block of kt_inv_chip<variant, group>, bytes."""
    smem = load().kt_inv_chip_smem(INV_VARIANTS.index(variant), group)
    if smem < 0:
        raise ValueError(f"no on-chip inversion chain {variant!r} at "
                         f"G = {group}")
    return smem


# ---- attributes and bounds ----

_FAMILIES = {"field_chain": (0, FIELD_OPS), "raw_chain": (1, RAW_OPS),
             "delta": (2, DELTA_VARIANTS), "inv_chain": (3, INV_VARIANTS),
             "inv_chip": (4, INV_VARIANTS)}


def attrs(family: str, name: str, arg: int = 0, smem: int = 0) -> dict:
    """Registers and local bytes per thread, static shared bytes per
    block and resident blocks per SM of a probe kernel (with `smem` bytes
    of dynamic shared memory; the on-chip P4 kernels with their own)."""
    fam, names = _FAMILIES[family]
    if family == "inv_chip":
        smem += inv_chip_smem(name, arg)
    out = (ctypes.c_int * 4)()
    lib = load()
    err = lib.kt_probe_attrs(fam, names.index(name), arg, smem, out)
    _raise(lib, err, f"attributes of {family}/{name}")
    return {"regs": out[0], "local_bytes": out[1], "smem": out[2] + smem,
            "blocks_per_sm": out[3]}


def bound_ms(counts: Dict[str, float], work: float,
             nbytes: float) -> Tuple[float, str]:
    """Least time on an H100 SXM for `work` element-rounds issuing
    `counts` slots of each class each (the slowest class at its peak, or
    the issue rate over every class; "fused" at its best mix of one ALU
    slot or two on either pipe; "imad2" an instruction of two IMAD slots
    and one issue slot, IMAD.WIDE), against `nbytes` of device memory
    traffic: (ms, "operations" or "bytes")."""
    counts = dict(counts)
    fused = counts.pop("fused", 0)
    wide = counts.pop("imad2", 0)
    if wide:
        counts["imad"] = counts.get("imad", 0) + 2 * wide
    alu, total = counts.get("alu", 0), sum(counts.values()) - wide
    # y of the fused on the ALU pipe: where the ALU pipe's time, rising
    # with y, meets the issue time, falling with it
    y = min(fused, max(0.0, (PEAK["alu"] * (total + 2 * fused)
                             - PEAK["issue"] * alu)
                       / (PEAK["issue"] + PEAK["alu"])))
    counts["alu"], counts["int"] = alu + y, (counts.get("int", 0)
                                             + 2 * (fused - y))
    per = [n / PEAK[k] for k, n in counts.items() if n and k in PEAK]
    per.append((sum(counts.values()) - wide) / PEAK["issue"])
    ops_s = work * max(per)
    bytes_s = nbytes / jump_cuda.HBM_RATE
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def field_counts(op: str, lanes: int) -> Dict[str, float]:
    """Slots per lane and round of a field chain over `lanes` lanes (the
    step: the walk's function, jump_cuda.imad_per_jump(lanes))."""
    if op == "step":
        return {"imad": jump_cuda.imad_per_jump(lanes)}
    return FIELD_COUNTS[op]


def delta_imad_per_jump(variant: str, group: int) -> float:
    """IMAD slots per lane and jump of a walk variant when `group` lanes
    share an inversion (as jump_cuda.imad_per_jump, with the variant's
    multiplies): at the kernel's G this design's count, at the herd's
    lane count the function's own need."""
    g = group
    muls, sqrs, inv = 3 * (g - 1) + 2 * g, g, jump_cuda.INV_IMAD
    if variant == "no_inv":
        muls, inv = 2 * g, 0
    elif variant == "no_sqr":
        sqrs -= g
    elif variant == "no_y3mul":
        muls -= g
    elif variant == "extra_mul":
        muls += g
    return (muls * jump_cuda.MUL_IMAD + sqrs * jump_cuda.SQR_IMAD + inv) / g


# The chain's step, canon(y - x) | 1 (probes.cuh inv_chain_next): an
# fe_sub, an fe_canon and the | 1 on 8 words (8 LOP3)
STEP = {"alu": 8, "int": SUB_INT + CANON_INT}


def inv_counts(variant: str, group: int) -> Dict[str, float]:
    """Slots per lane and iteration of an inversion chain whose groups
    hold `group` lanes: the function's own need, and the walk layout's
    count."""
    out = dict(STEP)
    if variant == "none":
        out["int"] += SUB_INT   # fn(x) = x - x
        return out
    imad = 3 * (group - 1) * jump_cuda.MUL_IMAD
    if variant == "cur":
        imad += jump_cuda.INV_IMAD
        out["int"] += INV_ALU / group
    out["imad"] = imad / group
    return out


def chip_smem_words(variant: str, run: int) -> float:
    """Shared-memory words per lane and iteration of the on-chip form
    whose runs hold `run` lanes (chip_run()): x loaded (8) and, for
    run - 2 lanes of a run, the prefix product stored in the forward
    pass; x loaded, for run - 1 lanes of a run the prefix loaded, and
    the next x stored (8 + 8) in the unwind (none: x loaded and
    stored)."""
    if variant == "none":
        return 16
    return 24 + 8 * (2 * run - 3) / run


def inv_chip_counts(variant: str, group: int, run: int) -> Dict[str, float]:
    """Slots per lane and iteration of the on-chip form (this design's
    count): the function's (inv_counts) and its shared-memory words."""
    return dict(inv_counts(variant, group),
                lds=chip_smem_words(variant, run))


def chip_run() -> int:
    """Lanes of a run of kt_inv_chip (probes.cuh CHIP_RUN), read from
    the library."""
    return load().kt_inv_chip_run()
