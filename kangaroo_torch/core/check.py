"""-wcheck (work-file re-derivation) and -check (the solver's
self-check), on the card or the CPU.

Counterpart of kangaroo_tpu/core/check.py.  -wcheck (reference:
CheckWorkFile / CheckPartition, Check.cpp:110-412): for every stored DP,
recompute dist*G (+keyToSearch when wild) in batches on the device and
verify that the low 128 bits of x and the bucket index match what the
file stores (`_derive_x`, `_check_batch`, `check_work_file`,
`check_partitioned`).  The file's buckets are parsed as numpy columns
(`io.backup.read_bucket_entries`) and checked about 2^20 at a time.

-check, run_self_check (:418) and its two oracles (reference:
Kangaroo::Check, Check.cpp:414-619):

  * the plain field ops against Python ints, the batched k*G against
    host double-and-add, and the plain walk against a host curve.add
    replay;
  * field_stress_check: 100k products and 10k inversions (20k and 4096
    on the CPU) of the plain ops and of field.cuh's own fe_mul and
    fe_inv -- on the card through the P1 probe kernel at one round
    (probe_cuda.field_chain), on the CPU through the g++ build of the
    same code (ops/host_kernel.py);
  * kernel_lockstep_check: the walk kernel against the plain walk in
    both modes -- on the card the CUDA kernel on one block, on the CPU
    the kernel's g++-built body at the same geometry (the counterpart of
    JAX's interpret mode).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..constants import H_PER_PART, HASH_SIZE, MERGE_PART, N_ORDER, P
from ..io import backup, merge as merge_mod
from ..ops import ec, field, host_kernel, jump_cuda, jump_ref, probe_cuda
from ..utils.intutils import ints_to_limbs_fast, limbs_to_ints_fast
from ..utils.rng import MT19937
from . import curve, herd as herd_mod
from .jumptable import create_jump_table
from .solver import resolve_device


def _limbs(vals, dev) -> torch.Tensor:
    return torch.from_numpy(ints_to_limbs_fast(vals).astype(np.int32)).to(dev)


def _ints(t: torch.Tensor) -> List[int]:
    return [int(v) for v in
            limbs_to_ints_fast(t.cpu().numpy().astype(np.uint32))]


# DPs re-derived per batch of -wcheck: about a second of the batched
# k*G on the card, where a 16384-lane batch leaves it launch-bound
WCHECK_BATCH = 1 << 20


@dataclass
class CheckReport:
    n_items: int = 0
    n_wrong: int = 0

    @property
    def ok(self) -> bool:
        return self.n_wrong == 0


def _derive_x(mag: torch.Tensor, neg: torch.Tensor, wild: torch.Tensor,
              key_to_search: curve.PointA, windows: int,
              both_signs: bool = False):
    """x-coords (16, N) of d*G, or keyToSearch + d*G on wild lanes, for
    the distances d = mag, or n - mag where neg (the D128 encoding).

    With both_signs, also the x of keyToSearch - d*G on every lane (the
    -sym walk's other branch); None otherwise.
    """
    sx, sy, zero = ec.signed_mult_base(mag, neg, windows)
    if not bool(wild.any()):
        return sx, None
    ax, ay = ec.add_point(sx, sy, zero, key_to_search)
    x = torch.where(wild[None, :], ax, sx)
    if not both_signs:
        return x, None
    return x, ec.add_point(sx, field.neg_y(sy), zero, key_to_search)[0]


def _check_batch(h: np.ndarray, xw: np.ndarray, dw: np.ndarray,
                 key_to_search: curve.PointA, symmetry: bool = False,
                 device="cuda") -> np.ndarray:
    """Re-derive dist*G (+key when wild) on `device`; the (m,) bool mask
    of records whose stored x or bucket does not match.

    Vectorized counterpart of CheckHash (Check.cpp:33-108).  h (m,)
    bucket ids, xw (m, 2) and dw (m, 2) the uint64 lo/hi halves of the
    stored X128 and D128 (file entries or wire records).  In symmetry
    mode the walk invariant is P = +-key + d*G (the class sign is not
    stored in the DP record), so a wild DP is valid when its x matches
    EITHER key + d*G or key - d*G; tame x is sign-invariant already.
    """
    dev = resolve_device(str(device))
    m = len(h)
    dw = np.asarray(dw, dtype=np.uint64)
    xw = np.asarray(xw, dtype=np.uint64)
    # D128: b127 sign (d = n - |d|), b126 type, b125..0 |d|
    types = ((dw[:, 1] >> np.uint64(62)) & np.uint64(1)).astype(bool)
    neg = (dw[:, 1] >> np.uint64(63)).astype(bool)
    mag = np.zeros((16, m), dtype=np.int32)
    mag[:8] = _u64_limbs(dw[:, 0], dw[:, 1] & np.uint64((1 << 62) - 1))
    want = np.zeros((10, m), dtype=np.int32)
    want[:8] = _u64_limbs(xw[:, 0], xw[:, 1])
    h = np.asarray(h, dtype=np.int64)
    want[8], want[9] = h & 0xFFFF, h >> 16
    want = torch.from_numpy(want).to(dev)
    wild = torch.from_numpy(types).to(dev)
    x, x2 = _derive_x(torch.from_numpy(mag).to(dev),
                      torch.from_numpy(neg).to(dev), wild, key_to_search,
                      ec.windows_for(mag), both_signs=symmetry)

    def matches(x):
        # low 128 bits and bits 128..145 (the bucket) of x
        return ((x[:8] == want[:8]).all(0) & (x[8] == want[8])
                & ((x[9] & 3) == want[9]))

    ok = matches(x)
    if x2 is not None:
        ok |= wild & matches(x2)
    return (~ok).cpu().numpy()


def _u64_limbs(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(m,) uint64 lo/hi halves -> (8, m) int32 16-bit limbs."""
    out = np.empty((8, len(lo)), dtype=np.int32)
    for i in range(4):
        out[i] = (lo >> np.uint64(16 * i)) & np.uint64(0xFFFF)
        out[4 + i] = (hi >> np.uint64(16 * i)) & np.uint64(0xFFFF)
    return out


def _key_to_search(hdr) -> curve.PointA:
    sp = hdr.range_start % N_ORDER
    if hdr.version == backup.SYM_VERSION:
        # -sym files recenter the key on the range midpoint (same
        # translation as KangarooSolver.init_search_key)
        sp = (sp + ((hdr.range_end - hdr.range_start) >> 1)) % N_ORDER
    if sp != 0:
        return curve.add(hdr.key, curve.mul(sp).neg())
    return hdr.key


def _check_regions(hdr, regions, batch: int, device) -> CheckReport:
    """Check every entry of the bucket regions (path, offset, buckets,
    first bucket id), batched across regions."""
    key = _key_to_search(hdr)
    sym = hdr.version == backup.SYM_VERSION
    report = CheckReport()
    pend: list = []

    def flush():
        if pend:
            h, x, d = (np.concatenate(c) for c in zip(*pend))
            report.n_wrong += int(_check_batch(h, x, d, key, sym,
                                               device).sum())
            report.n_items += len(h)
            pend.clear()

    for path, off, n_buckets, h_base in regions:
        for cols in backup.read_bucket_entries(path, off, n_buckets, batch,
                                               h_base):
            pend.append(cols)
            if sum(len(c[0]) for c in pend) >= batch:
                flush()
    flush()
    return report


def check_work_file(path: str, batch: int = WCHECK_BATCH,
                    device="cuda") -> CheckReport:
    """-wcheck on a plain work file or a 256-partition directory, on
    `device` (the card unless the caller asks for the CPU)."""
    resolve_device(str(device))
    if os.path.isdir(path):
        return check_partitioned(path, batch, device)
    with open(path, "rb") as f:
        hdr = merge_mod.read_work_header(f, path)
    return _check_regions(
        hdr, [(path, backup.HEADW_HEADER_SIZE, HASH_SIZE, 0)], batch,
        device)


def check_partitioned(directory: str, batch: int = WCHECK_BATCH,
                      device="cuda") -> CheckReport:
    """-wcheck on a partitioned work dir (reference: CheckPartition)."""
    resolve_device(str(device))
    header = os.path.join(directory, "header")
    with open(header, "rb") as f:
        hdr = merge_mod.read_work_header(f, header)
    return _check_regions(
        hdr, [(merge_mod.part_name(directory, p), 0, H_PER_PART,
               p * H_PER_PART) for p in range(MERGE_PART)], batch, device)


def structured_field_values() -> List[int]:
    """Adversarial operand pool mirroring Int::Check's structured scans
    (+/-2^i, P-k, small k; SECPK1/Int.cpp:1590-1809) plus divstep-
    specific pathologies: long even runs (low 32/64/128/224 bits zero --
    the packed inner loop consumes 32-bit low words), and alternating
    bit patterns."""
    vals: List[int] = []
    for i in range(256):
        vals.append(pow(2, i, P))
        vals.append(P - pow(2, i, P))
    vals.extend(P - k for k in range(1, 1025))
    vals.extend(range(1, 1025))
    rnd = random.Random(0x57E55)
    for shift in (32, 64, 128, 224):
        for _ in range(256):
            vals.append((rnd.randrange(1, 1 << (256 - shift)) << shift) % P)
    for pat in (0x5555, 0xAAAA, 0x3333, 0x0F0F):
        v = int(("%04x" % pat) * 16, 16) % P
        vals.append(v)
        vals.append(P - v)
    return [v % P for v in vals if v % P != 0]


def _cuh_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """field.cuh's fe_mul: the P1 kernel at one round on the card, the
    g++ build on the CPU."""
    if a.is_cuda:
        return probe_cuda.field_chain("mul", a.clone(), b, 1)
    return host_kernel.fe_mul(a, b)


def _cuh_inv(a: torch.Tensor) -> torch.Tensor:
    """field.cuh's fe_inv, as _cuh_mul."""
    if a.is_cuda:
        return probe_cuda.field_chain("inv", a.clone(), a, 1)
    return host_kernel.fe_inv(a)


def field_stress_check(device="cuda", n_mul: int = 100_000,
                       n_inv: int = 10_000, chunk: int = 4096,
                       verbose: bool = True) -> bool:
    """Volume arithmetic oracle: n_mul products against exact big-int
    products and n_inv inversions against Fermat, structured pool first
    then random fill (reference: Int::Check's 100k ModMulK1 / 10k ModInv
    sweeps, SECPK1/Int.cpp:1668-1809), through the plain ops and through
    field.cuh's fe_mul and fe_inv."""
    dev = resolve_device(device)
    rnd = random.Random(0xF00D5)
    pool = structured_field_values()

    def run_chunks(vals_a, vals_b, op):
        out = []
        for i in range(0, len(vals_a), chunk):
            ca = list(vals_a[i:i + chunk])
            pad = chunk - len(ca)
            args = [_limbs(ca + [1] * pad, dev)]
            if vals_b is not None:
                args.append(_limbs(list(vals_b[i:i + chunk]) + [1] * pad,
                                   dev))
            out.extend(_ints(op(*args))[:chunk - pad])
        return out

    def report(name, bad, n, what):
        if verbose:
            print(f"Check: {name} volume FAILED ({bad}/{n} wrong)" if bad
                  else f"Check: {name} volume OK ({n} {what})")
        return not bad

    fill = max(0, n_mul - len(pool))
    avals = (pool + [rnd.randrange(1, P) for _ in range(fill)])[:n_mul]
    bvals = (list(reversed(pool))
             + [rnd.randrange(1, P) for _ in range(fill)])[:n_mul]
    want = [a * b % P for a, b in zip(avals, bvals)]
    ok = True
    for name, op in (("mulmod", field.mulmod), ("fe_mul", _cuh_mul)):
        got = run_chunks(avals, bvals, op)
        bad = sum(1 for g, w in zip(got, want)
                  if g >= (1 << 256) or g % P != w)
        ok = report(name, bad, n_mul, "products, structured+random") and ok
    ivals = (pool + [rnd.randrange(1, P)
                     for _ in range(max(0, n_inv - len(pool)))])[:n_inv]
    want = [pow(v, P - 2, P) for v in ivals]
    for name, op in (("modinv", field.modinv), ("fe_inv", _cuh_inv)):
        got = run_chunks(ivals, None, op)
        bad = sum(1 for g, w in zip(got, want) if g != w)
        ok = report(name, bad, n_inv, "inversions vs Fermat") and ok
    return ok


_EXACT = ("px", None, "d", "count", "dpx", "dpd", "step", "symclass")


def kernel_lockstep_check(device="cuda", n: int = jump_cuda.LANE_QUANTUM,
                          nb_run: int = 300, dp_size: int = 6,
                          slots: int = 2, verbose: bool = True,
                          walk: Optional[Callable] = None) -> bool:
    """The walk kernel against the plain walk, both modes.

    The counterpart of pallas_lockstep_check (kangaroo_tpu/core/
    check.py:314): a window at the kernel's geometry (one block by
    default), step indices past 255 and a dp at which lanes overflow
    their slots.  `walk` is the kernel (jump_cuda.jump_steps_with_dp's
    contract); by default the CUDA kernel on the card and its g++-built
    body on the CPU.  Bit-equality contract (:330-333): px (canonical),
    d, symclass, count and every DP slot (x, d, step) exactly; py, which
    the plain walk carries relaxed, mod p.
    """
    dev = resolve_device(device)
    if walk is None:
        walk = (jump_cuda.jump_steps_with_dp if dev.type == "cuda"
                else host_kernel.walk)
    rng = np.random.RandomState(0xD00D)
    state = [torch.from_numpy(rng.randint(0, 1 << 16, (rows, n)).astype(
        np.int32)).to(dev) for rows in (16, 16, 8)]
    masks = jump_ref.dp_limb_masks(dp_size, dev)
    ok = True
    for symmetry in (False, True):
        tabs = [torch.from_numpy(t.astype(np.int32)).to(dev) for t in
                create_jump_table(64, symmetry=symmetry).as_arrays()]
        sym = ({"symmetry": True,
                "symclass": torch.zeros(n, dtype=torch.int32, device=dev)}
               if symmetry else {})
        ref = jump_ref.jump_steps_with_dp(
            *[t.clone() for t in state], *tabs, masks, nb_run=nb_run,
            slots=slots, **sym)
        sym = {k: (v.clone() if torch.is_tensor(v) else v)
               for k, v in sym.items()}
        got = walk(*[t.clone() for t in state], *tabs, masks,
                   nb_run=nb_run, slots=slots, **sym)
        label = f"kernel lockstep [{dev.type}, sym={symmetry}]"
        sub_ok = True
        for name, r, g in zip(_EXACT, ref, got):
            if name is None:  # py: mod p
                r, g = field.canonicalize(r), field.canonicalize(g)
                name = "py"
            if not torch.equal(r, g):
                sub_ok = False
                if verbose:
                    print(f"Check: {label} MISMATCH in {name}")
        cnt = ref[3]
        top = int(cnt.max()) if cnt.numel() else 0
        if top <= slots and verbose:
            print(f"Check: {label} WARNING: no slot overflow exercised")
        if sub_ok and verbose:
            print(f"Check: {label} OK ({n} lanes x {nb_run} steps, "
                  f"{int((cnt > 0).sum())} DP lanes, max hits/lane {top})")
        ok = ok and sub_ok
    return ok


def run_self_check(device="cuda", verbose: bool = True) -> bool:
    """-check: arithmetic known-answer tests, the batched k*G, the walk
    against a host replay, the volume oracle and the kernel lockstep, on
    `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rnd = random.Random(0xC43C)
    ok = True

    n = 256
    avals = [rnd.randrange(P) for _ in range(n)]
    bvals = [rnd.randrange(P) for _ in range(n)]
    a, b = _limbs(avals, dev), _limbs(bvals, dev)
    checks = [
        ("addmod", field.addmod(a, b),
         [(x + y) % P for x, y in zip(avals, bvals)]),
        ("submod", field.submod(a, b),
         [(x - y) % P for x, y in zip(avals, bvals)]),
        ("mulmod", field.mulmod(a, b),
         [x * y % P for x, y in zip(avals, bvals)]),
        ("sqrmod", field.sqrmod(a), [x * x % P for x in avals]),
        ("modinv", field.modinv(a), [pow(x, -1, P) for x in avals]),
        ("batchinv", field.batch_inv(a), [pow(x, -1, P) for x in avals]),
    ]
    for name, got, want in checks:
        # field ops are relaxed (< 2^256 representatives); compare mod p
        good = [g % P for g in _ints(got)] == want
        ok = ok and good
        if verbose:
            print(f"Check: {name} {'OK' if good else 'FAILED'}"
                  + (f" ({n} lanes)" if good else ""))

    # batched scalar mult vs host double-and-add (Check.cpp:428-457)
    n_scalar = 2048 if on_card else 256
    ks = [rnd.randrange(1, N_ORDER) for _ in range(n_scalar)]
    gx, gy, _ = ec.scalar_mult_base_batch(_limbs(ks, dev))
    got = list(zip(_ints(gx), _ints(gy)))
    bad = next((i for i, k in enumerate(ks)
                if curve.mul(k) != curve.PointA(*got[i])), None)
    ok = ok and bad is None
    if verbose:
        print(f"Check: scalar_mult FAILED at {bad}" if bad is not None
              else f"Check: scalar_mult_base_batch OK ({n_scalar} keys)")

    # the plain walk vs a host scalar replay
    range_power = 64
    width_div2 = ((1 << range_power) - 1) >> 1
    px, py, d = herd_mod.create_herd(64, range_power, width_div2,
                                     curve.mul(0xBADC0FFEE), 0, MT19937(7),
                                     device=dev)
    jt = create_jump_table(range_power)
    tabs = [torch.from_numpy(t.astype(np.int32)).to(dev)
            for t in jt.as_arrays()]
    pts = [curve.PointA(x, y) for x, y in zip(_ints(px), _ints(py))]
    dists = _ints(d)
    opx, _, od, *_ = jump_ref.jump_steps_with_dp(
        px, py, d, *tabs, jump_ref.dp_limb_masks(8, dev), nb_run=8)
    for _ in range(8):
        for i in range(64):
            j = pts[i].x & 31
            pts[i] = curve.add(pts[i], jt.points[j])
            dists[i] = (dists[i] + jt.distances[j]) & ((1 << 128) - 1)
    bad = next((i for i, (x, dd) in enumerate(zip(_ints(opx), _ints(od)))
                if (x, dd) != (pts[i].x, dists[i])), None)
    ok = ok and bad is None
    if verbose:
        print(f"Check: walk lockstep FAILED at lane {bad}" if bad is not None
              else "Check: walk lockstep OK (64 lanes x 8 steps)")

    # volume arithmetic (reference: 100k ModMulK1 / 10k ModInv); the CPU
    # keeps -check interactive with a smaller random fill, always the
    # full structured pool
    if on_card:
        ok = field_stress_check(dev, verbose=verbose) and ok
        ok = kernel_lockstep_check(dev, verbose=verbose) and ok
    else:
        ok = field_stress_check(dev, n_mul=20_000, n_inv=4_096,
                                verbose=verbose) and ok
        ok = kernel_lockstep_check(dev, nb_run=24, dp_size=3,
                                   verbose=verbose) and ok
    if verbose:
        print("Check: ALL OK" if ok else "Check: FAILURES DETECTED")
    return ok
