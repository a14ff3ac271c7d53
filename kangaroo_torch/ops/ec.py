"""Batched secp256k1 curve operations in plain PyTorch (limb-sliced).

Point coordinates use the (16, N) int32 limb layout of `ops.field`.
These cover the herd's start positions: a masked batched affine add and
the batched fixed-window scalar multiplication, the vectorized
counterparts of the reference's Secp256K1::AddDirect /
ComputePublicKeys (SECP256K1.cpp:59-113,238-322).  In the JAX package
they are XLA code (kangaroo_tpu/ops/ec.py).

On a card the herd's positions come from the CUDA kernel
`kt_herd_kernel` (`ops/herd_cuda.py`); the composition here is its
plain version (`herd_cuda.positions_plain`), the path for CPU tensors,
and the path of the work files' `-wss` herd rebuild (`io/backup.py`)
and `-wcheck` (`core/check.py`), which call it directly on any device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..constants import NB_LIMB
from ..core import curve
from ..utils.intutils import int_to_limbs
from . import field


def affine_add_batch_masked(
    accx: torch.Tensor,
    accy: torch.Tensor,
    acc_zero: torch.Tensor,
    qx: torch.Tensor,
    qy: torch.Tensor,
    q_zero: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """acc + q where either side may be the identity, lane-wise.

    Mirrors the vector AddDirect contract (accept p1 == 0,
    SECP256K1.cpp:296-298) extended with q == 0 lanes for windowed
    scalar multiplication.  Doubling (acc == +-q) is not handled, as in
    the reference.  Canonical outputs.
    """
    active = (~acc_zero) & (~q_zero)
    dx = field.submod(qx, accx)
    one = torch.zeros_like(dx)
    one[0] = 1
    inv = _batch_inv(torch.where(active[None, :], dx, one))
    dy = field.submod(qy, accy)
    lam = field.mulmod(dy, inv)
    x3 = field.canonicalize(field.submod(field.sqrmod(lam, sub=(accx,)), qx))
    y3 = field.canonicalize(
        field.submod(field.mulmod(lam, field.submod(qx, x3)), qy)
    )
    outx = torch.where(acc_zero[None, :], qx,
                       torch.where(q_zero[None, :], accx, x3))
    outy = torch.where(acc_zero[None, :], qy,
                       torch.where(q_zero[None, :], accy, y3))
    return outx, outy, acc_zero & q_zero


def _batch_inv(a: torch.Tensor) -> torch.Tensor:
    """field.batch_inv of any lane count: the lanes are padded with ones
    to a width whose fold tree ends at 64 lanes or fewer, since its root
    is inverted on the host lane by lane (an odd-width batch of DPs to
    check would otherwise invert every lane in Python).  A width that
    folds that far already, such as a herd's power of two, is not
    padded."""
    n = a.shape[1]
    k = max(0, (n - 1).bit_length() - 6)
    m = -(-n // (1 << k)) << k
    if m == n:
        return field.batch_inv(a)
    pad = torch.zeros((a.shape[0], m - n), dtype=a.dtype, device=a.device)
    pad[0] = 1
    return field.batch_inv(torch.cat([a, pad], dim=1))[:, :n]


@lru_cache(maxsize=1)
def _gtable_np() -> np.ndarray:
    """Fixed-window generator table: (32, 2, 16, 256) int32.

    GTable[w, :, :, j] = (j+1) * 2^(8w) * G, built once on the host
    (cold path).  Same table as the reference (SECP256K1.cpp:43-53),
    stored limb-sliced for lane gathers.
    """
    tbl = np.zeros((32, 2, NB_LIMB, 256), dtype=np.int32)
    base = curve.G
    for w in range(32):
        acc = base
        for j in range(256):
            tbl[w, 0, :, j] = int_to_limbs(acc.x)
            tbl[w, 1, :, j] = int_to_limbs(acc.y)
            acc = curve.add(acc, base)
        base = curve.mul(256, base)
    return tbl


def scalar_mult_base_batch(ks: torch.Tensor, windows: int = 32):
    """Batched k*G by byte windows over the generator table.

    ks: int32 (16, N) limbs of scalars (already reduced mod n), on the
    device the result should live on.  Only the low `windows` bytes are
    used: the caller passes fewer than 32 when every scalar is below
    2^(8 * windows).  Returns (x, y, is_zero) with is_zero marking
    k == 0 lanes.
    """
    tbl = torch.from_numpy(_gtable_np()).to(ks.device)
    n = ks.shape[1]
    accx = torch.zeros((NB_LIMB, n), dtype=torch.int32, device=ks.device)
    accy = torch.zeros_like(accx)
    acc_zero = torch.ones((n,), dtype=torch.bool, device=ks.device)
    for w in range(windows):
        b = ((ks[w // 2] >> (8 * (w % 2))) & 0xFF).long()
        idx = torch.clamp(b - 1, min=0)
        accx, accy, acc_zero = affine_add_batch_masked(
            accx, accy, acc_zero, tbl[w, 0][:, idx], tbl[w, 1][:, idx],
            b == 0,
        )
    return accx, accy, acc_zero


def windows_for(mag: np.ndarray) -> int:
    """Byte windows of scalar_mult_base_batch that cover every column of
    the (L, N) 16-bit limb array mag (at least one)."""
    rows = np.flatnonzero(np.asarray(mag).any(axis=1))
    if not len(rows):
        return 1
    top = int(rows[-1])
    bits = 16 * top + int(np.asarray(mag[top]).max()).bit_length()
    return max(1, -(-bits // 8))


def signed_mult_base(mag: torch.Tensor, neg: torch.Tensor, windows: int):
    """k*G for k = mag, or k = n - mag on lanes where neg: since
    (n - m)*G = -(m*G), the multiply runs over the `windows` bytes of
    the magnitude and neg lanes take p - y.  mag: int32 (16, N) limbs
    below 2^(8 * windows); neg: (N,) bool.  Returns (x, y, is_zero),
    canonical: the same values as the 32-window multiply of k mod n.  A
    k = 0 lane (the identity, which has no affine coordinates) carries
    what that multiply leaves there, the last window's first entry
    2^248*G, as in the JAX package."""
    sx, sy, zero = scalar_mult_base_batch(mag, windows)
    # every y here lies in (0, p): no point of order 2 on secp256k1
    sy = torch.where(neg[None, :], field.neg_y(sy), sy)
    last = torch.from_numpy(_gtable_np()[31, :, :, 0]).to(mag.device)
    z = zero[None, :]
    return (torch.where(z, last[0][:, None], sx),
            torch.where(z, last[1][:, None], sy), zero)


def add_point(px: torch.Tensor, py: torch.Tensor, p_zero: torch.Tensor,
              q: curve.PointA):
    """q + P lane-wise for one fixed affine point q (a lane whose
    p_zero is set gives q itself).  Returns canonical (x, y)."""
    n = px.shape[1]
    qx, qy = (torch.from_numpy(int_to_limbs(v).astype(np.int32))
              .to(px.device)[:, None].expand(-1, n) for v in (q.x, q.y))
    none = torch.zeros((n,), dtype=torch.bool, device=px.device)
    x, y, _ = affine_add_batch_masked(px, py, p_zero, qx, qy, none)
    return x, y
