"""Plain PyTorch versions of the probe kernels (`csrc/probe_kernels.cu`).

Each computes what its kernel computes, on the port's plain field
arithmetic (`ops/field.py`), on any device; the tests hold them against
the TPU probes' own bodies and the g++-built kernel bodies, and
`chip_smoke.py` holds the kernels against them on the card.  Nothing
else calls them where there is a card (`ops/probe_cuda.py` launches the
kernels for CUDA tensors).

  field_chain  P1 (scripts/pkbench.py): a <- op(a, b) `rounds` times;
  raw_chain    P2 (scripts/probe_ops.py, scripts/layout_probe.py): one
               32-bit instruction per element and iteration (shr16's in
               three kernels, SHR16_OPS);
  delta_walk   P3 (scripts/pkdelta.py): the walk with one component
               switched;
  inv_chain    P4 (scripts/pkinv.py): x <- canon(fn(x) - x) | 1, for
               both of its kernels (the walk's layout and the on-chip
               form group lanes alike: `lane_sets`).

The names below are the kernels' op and variant ids, in order.  The
gather's xor, the step's x3 ^ y3 and P4's | 1 read canonical values, as
in the kernels, so the chains do not depend on which relaxed
representative the field ops return.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import NB_JUMP
from . import field, jump_ref

FIELD_OPS = ("mul", "sqr", "sub", "add", "fold", "canon", "inv", "gather",
             "step")
RAW_OPS = ("u32_add", "u32_mul", "mask16", "shr16", "i32_mul", "f32_add",
           "f32_mul", "f32_fma", "wide", "layout", "empty", "shr16_mix",
           "shr16_hi")
# shr16's function in three kernels: its shift-and-adds on the ALU pipe
# (LEA.HI), some on the multiply-add pipe (IMAD.HI), or all there
SHR16_OPS = ("shr16", "shr16_mix", "shr16_hi")
F32_OPS = ("f32_add", "f32_mul", "f32_fma")
DELTA_VARIANTS = ("base", "no_inv", "no_sqr", "no_y3mul", "extra_mul",
                  "extra_sub", "no_dp", "fixed_gather", "extra_traffic")
INV_VARIANTS = ("cur", "nodiv", "none")

THREADS = 128  # threads per block of every probe kernel (walk.cuh)
M32 = 0xFFFFFFFF


def _fold_addend(b: torch.Tensor) -> torch.Tensor:
    """(b & 1) * (2^32 + 977) as (16, N) limbs: 2^256 mod p, or 0."""
    k = b[0].long() & 1
    c = torch.zeros_like(b)
    c[0] = (k * field.C_LOW).to(torch.int32)
    c[2] = k.to(torch.int32)
    return c


def field_chain(op: str, a: torch.Tensor, b: torch.Tensor, rounds: int,
                jx=None, jy=None) -> torch.Tensor:
    """P1: `rounds` rounds of op on a with b fixed; (16, N) int32 limbs.

    Field ops return relaxed values (compare them canonical); gather
    (a ^ jx[:, a & 31]) and step (a <- x3 ^ canon(y3) of the affine add
    (a, b) + (jx, jy)[a & 31]) are exact.
    """
    if op not in FIELD_OPS:
        raise ValueError(f"unknown field op {op!r}")
    fold = _fold_addend(b) if op == "fold" else None
    for _ in range(rounds):
        if op == "mul":
            a = field.mulmod(a, b)
        elif op == "sqr":
            a = field.sqrmod(a)
        elif op == "sub":
            a = field.submod(a, b)
        elif op == "add":
            a = field.addmod(a, b)
        elif op == "fold":
            a = field.addmod(a, fold)
        elif op == "canon":
            a = field.canonicalize(a)
        elif op == "inv":
            a = field.modinv(a)
        elif op == "gather":
            a = a ^ jx[:, (a[0] & (NB_JUMP - 1)).long()]
        else:
            j = (a[0] & (NB_JUMP - 1)).long()
            x3, y3 = jump_ref.affine_add_walk(a, b, jx[:, j], jy[:, j])
            a = x3 ^ field.canonicalize(y3)
    return a


def reduce512(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo + hi * 2^256 mod p, relaxed; (16, N) int32 limbs each."""
    cols = torch.cat([lo, hi]).to(torch.int64)
    return field._reduce_cols(cols, field.M16).to(torch.int32)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding values < 2^32, with no
    intermediate above 2^49."""
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def _wide_halves(a, b, i: int) -> torch.Tensor:
    """lo + hi (mod 2^32) of the 64-bit a * b + i."""
    p0 = (a & 0xFFFF) * b                        # < 2^48
    p1 = (a >> 16) * b                           # < 2^48
    lo = p0 + ((p1 & 0xFFFF) << 16) + i
    hi = (p1 >> 16) + (lo >> 32)
    return ((lo & M32) + (hi & M32)) & M32


def raw_chain(op: str, x: torch.Tensor, inner: int) -> torch.Tensor:
    """P2: `inner` iterations of op on every element of x, int32 (the
    u32 bits) or float32 for the f32 ops; returns the kernel's output
    (a + b for the probe_ops rows, x for layout and empty).

    The integer ops compute in int64 masked to 32 bits (bit-equal to the
    kernel); the f32 ops in float32 with the kernel's order of
    operations, the fused multiply-add rounded once from float64 (equal
    within one rounding).
    """
    if op not in RAW_OPS:
        raise ValueError(f"unknown raw op {op!r}")
    if op in F32_OPS:
        a = x.clone()
        b = x.clone()
        for i in range(inner):
            # the loop-index mix in float32: 1 + i * 1e-9
            m = float(np.float32(1.0) + np.float32(i) * np.float32(1e-9))
            if op == "f32_add":
                a = (a + b) + m
            elif op == "f32_mul":
                a = (a * b) + m
            else:
                a = (a.double() * b.double() + b.double()).float() + m
            b = a + 1.0
        return a + b
    a = x.long() & M32
    b = a.clone()
    for i in range(inner):
        if op == "u32_add":
            a = (a + b + i) & M32
        elif op in ("u32_mul", "i32_mul"):
            a = (_mul32(a, b) + i) & M32
        elif op == "mask16":
            a = ((a & 0xFFFF) + i) & M32
        elif op in SHR16_OPS:
            a = ((a >> 16) + i) & M32
        elif op == "wide":
            a = _wide_halves(a, b, i)
        elif op == "layout":
            a = (_mul32(a, a ^ (i + 1)) + 1) & M32
        else:
            a = (a + 1) & M32
        if op == "i32_mul":
            b = (a + 1) & M32
        elif op not in ("layout", "empty"):
            b = a ^ b
    out = a if op in ("layout", "empty") else (a + b) & M32
    return (out - ((out >> 31) << 32)).to(torch.int32)


def delta_walk(variant: str, px, py, d, jx, jy, jd, dp_masks, nb_run: int,
               slots: int):
    """P3: `jump_ref.jump_steps_with_dp` (plain mode) with one component
    switched; same returns (px, py, d, count, dpx, dpd, step).  `base`
    is the production walk; `extra_traffic` computes what base computes
    (its kernel only moves more bytes)."""
    if variant not in DELTA_VARIANTS:
        raise ValueError(f"unknown walk variant {variant!r}")
    n = px.shape[1]
    dev = px.device
    dpx = torch.zeros((slots, jump_ref.DPX_ROWS, n), dtype=torch.int32,
                      device=dev)
    dpd = torch.zeros((slots, 8, n), dtype=torch.int32, device=dev)
    step = torch.zeros((slots, n), dtype=torch.int32, device=dev)
    count = torch.zeros((n,), dtype=torch.int32, device=dev)
    for i in range(nb_run):
        if variant == "fixed_gather":
            jmp = torch.full((n,), i & (NB_JUMP - 1), dtype=torch.long,
                             device=dev)
        else:
            jmp = (px[0] & (NB_JUMP - 1)).long()
        qx, qy, qd = jx[:, jmp], jy[:, jmp], jd[:, jmp]
        dx = field.submod(qx, px)
        inv = dx if variant == "no_inv" else field.batch_inv(dx)
        lam = field.mulmod(field.submod(qy, py), inv)
        lam2 = lam if variant == "no_sqr" else field.sqrmod(lam)
        x3 = field.canonicalize(field.submod(field.submod(lam2, px), qx))
        t1 = field.submod(qx, x3)
        y3 = field.submod(t1 if variant == "no_y3mul"
                          else field.mulmod(lam, t1), qy)
        if variant == "extra_mul":
            y3 = field.mulmod(y3, lam)
        if variant == "extra_sub":
            y3 = field.submod(y3, lam)
        px, py, d = x3, y3, field.add_u128(d, qd)
        if variant != "no_dp":
            jump_ref.record_dps(jump_ref.is_dp(px, dp_masks), i, px, d,
                                count, dpx, dpd, step)
    return px, py, d, count, dpx, dpd, step


def lane_sets(n: int, group: int) -> torch.Tensor:
    """The lane sets that the P4 kernels invert together on n lanes, one
    row per kernel thread: thread t of block b owns lanes
    b*THREADS*group + g*THREADS + t, g < group ((n / group, group)
    int64)."""
    if n % (THREADS * group):
        raise ValueError(f"{n} lanes is not a multiple of {THREADS} x "
                         f"{group}")
    lanes = torch.arange(n).reshape(n // (THREADS * group), group, THREADS)
    return lanes.permute(0, 2, 1).reshape(-1, group)


def _group_products(x: torch.Tensor, sets: torch.Tensor, invert: bool):
    """Per lane: the inverse of x (invert) or, without the inversion, the
    product of the lane's set times the product of the others in it
    (R^2 / x).  `sets` (m, G) holds each lane once, G a power of two.
    The fold tree of kangaroo_tpu's batch_inv over the lanes permuted so
    that each set's lanes fold together."""
    m = sets.shape[0]
    order = sets.t().reshape(-1).to(x.device)  # column j*m + i: sets[i, j]
    cur = x[:, order]
    levels = []
    while cur.shape[1] > m:
        half = cur.shape[1] // 2
        levels.append(cur)
        cur = field.mulmod(cur[:, :half], cur[:, half:])
    root = field.modinv(cur) if invert else cur
    for lev in reversed(levels):
        half = lev.shape[1] // 2
        root = torch.cat([field.mulmod(root, lev[:, half:]),
                          field.mulmod(root, lev[:, :half])], 1)
    out = torch.empty_like(x)
    out[:, order] = root
    return out


def inv_chain(variant: str, x: torch.Tensor, iters: int,
              group: int = 64, sets=None) -> torch.Tensor:
    """P4: `iters` rounds of x <- canon(fn(x) - x) | 1 on (16, N) limbs
    (the | 1 on every limb, as pkinv's), fn the batch inversion over
    sets of lanes (cur), the same without its inversion (nodiv), or
    x - x (none).  The sets are the kernels' for G = `group`
    (lane_sets), or `sets` ((m, G) lane indices, each lane once, G a
    power of two)."""
    if variant not in INV_VARIANTS:
        raise ValueError(f"unknown inversion variant {variant!r}")
    n = x.shape[1]
    sets = (lane_sets(n, group) if sets is None
            else torch.as_tensor(sets, dtype=torch.int64).cpu())
    if not torch.equal(sets.reshape(-1).sort().values, torch.arange(n)):
        raise ValueError(f"the lane sets do not hold each of {n} lanes once")
    if sets.shape[1] & (sets.shape[1] - 1):
        raise ValueError(f"sets of {sets.shape[1]} lanes: not a power of two")
    for _ in range(iters):
        if variant == "none":
            y = field.submod(x, x)
        else:
            y = _group_products(x, sets, variant == "cur")
        x = field.canonicalize(field.submod(y, x)) | 1
    return x
