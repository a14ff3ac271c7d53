"""Plain PyTorch secp256k1 field arithmetic (limb-sliced, lanes last).

256-bit field elements are int32 tensors of shape (16, N) holding 16-bit
limbs, least-significant limb first, across N lanes -- the JAX
package's layout, so the tests compare like with like.  Every op widens
to int64 inside (a 16x16-bit product needs 32 unsigned bits) and
returns int32.  These are the plain versions of the walk kernel's
arithmetic (`csrc/field.cuh`): the CPU path, the plain version of the
herd kernel's scalar multiply (`ops/ec.py`), and the reference the
kernels are compared with on the card.

Values are relaxed (any representative < 2^256) unless a function says
canonical (< p); p = 2^256 - c with c = 2^32 + 977.

Carries: a relaxed pass (limb & 0xFFFF plus the carry of the limb
below) shrinks wide columns; once every entry is <= 2^17 - 2 an exact
pass resolves the remaining 0/1 carries at once by packing the generate
and propagate bits of all rows into one int64 and adding (the carry
identity carries(x + y) = x ^ y ^ (x + y)).  Every shape is static, so
the op count does not depend on the data.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..constants import K1_C, P
from ..utils.intutils import ints_to_limbs_fast, limbs_to_ints_fast

C_LOW = K1_C - (1 << 32)  # 977
M16 = 0xFFFF
_EXACT_MAX = (1 << 17) - 2  # entry bound of the packed exact carry
_I64 = torch.int64


@lru_cache(maxsize=None)
def _limb_col(v: int, rows: int, device: torch.device) -> torch.Tensor:
    """Constant (rows, 1) int64 column of the 16-bit limbs of v."""
    return torch.tensor(
        [(v >> (16 * i)) & M16 for i in range(rows)], dtype=_I64,
        device=device,
    )[:, None]


@lru_cache(maxsize=None)
def _iota(rows: int, device: torch.device) -> torch.Tensor:
    return torch.arange(rows, dtype=_I64, device=device)[:, None]


def _relax(x: torch.Tensor) -> torch.Tensor:
    """One relaxed carry pass: (R, N) -> (R+1, N), same value."""
    z = torch.zeros_like(x[:1])
    return torch.cat([x & M16, z]) + torch.cat([z, x >> 16])


def _exact(x: torch.Tensor):
    """Exact carry of (R, N) entries in [0, 2^17 - 2].

    Returns (limbs < 2^16 (R, N), carry out of the top row (N,)).
    """
    rows = x.shape[0]
    iota = _iota(rows, x.device)
    lo = x & M16
    g = x >> 16                                  # generate, 0/1
    p = ((lo + 1) >> 16)                         # propagate: lo == 0xFFFF
    gpk = (g << iota).sum(0)
    ppk = (p << iota).sum(0)
    inj = gpk << 1                               # generates, one bit up
    z = ppk + inj
    cin_pk = inj | (z ^ ppk ^ inj)               # carry into each row
    cin = (cin_pk[None, :] >> iota) & 1
    return (lo + cin) & M16, (cin_pk >> rows) & 1


def _to_limbs(x: torch.Tensor, mx: int, rows: int) -> torch.Tensor:
    """Nonnegative columns (entries <= mx) -> exact 16-bit limbs.

    Returns `rows` limbs; the caller's value bound guarantees that the
    rows cut off are zero.
    """
    while mx > _EXACT_MAX:
        x = _relax(x)
        mx = M16 + (mx >> 16)
    limbs, out = _exact(x)
    return torch.cat([limbs, out[None, :]])[:rows]


def _add_c(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x + k * c on 16 rows (c = 977 at row 0, 1 at row 2)."""
    x = x.clone()
    x[0] += k * C_LOW
    x[2] += k
    return x


def _final(y: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """Exact limbs y (16 rows) plus top * 2^256 (top <= 67) -> relaxed
    (16, N) < 2^256.  If the first fold carries out, what is left is
    < 67c, so the second fold cannot carry again."""
    z, o = _exact(_add_c(y, top))
    z, _ = _exact(_add_c(z, o))
    return z


def _fold(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo + hi * 2^256 == lo + hi * 977 + hi * 2^32 (mod p), columns."""
    h = hi.shape[0]
    out = torch.cat([lo, torch.zeros_like(lo[:max(0, h + 2 - 16)])])
    out[:h] += hi * C_LOW
    out[2:h + 2] += hi
    return out


def _reduce_cols(cols: torch.Tensor, mx: int) -> torch.Tensor:
    """Columns of a value < 2^512 (entries <= mx) -> relaxed (16, N)."""
    x = _to_limbs(cols, mx, 32)                  # exact 512-bit value
    t = _fold(x[:16], x[16:])                    # < 2^289, 18 rows
    y = _to_limbs(t, 979 * M16, 19)
    t = _fold(y[:16], y[16:])                    # < 2^256 + 2^67
    z = _to_limbs(t, 979 * M16, 17)
    return _final(z[:16], z[16])


def addmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p, relaxed."""
    y, o = _exact(a.to(_I64) + b.to(_I64))
    return _final(y, o).to(torch.int32)


def submod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, relaxed, for any a, b < 2^256.

    Computes a + 2p + (~b) + 1 = a - b + 2p + 2^256 with the 2^256 of
    2p implicit: the sum a - b + 2p is positive for every b < 2^256.
    """
    t = (a.to(_I64) + _limb_col(2 * P - (1 << 256), 16, a.device)
         + (M16 ^ b.to(_I64)))
    t[0] += 1
    z = _to_limbs(t, 3 * M16 + 1, 17)            # value < 2^258
    return _final(z[:16], z[16]).to(torch.int32)


def mulmod(a: torch.Tensor, b: torch.Tensor,
           sub: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """(a * b - sum(sub)) mod p, relaxed.

    The 31 product columns accumulate one (16, N) partial product at a
    time, so the widest temporary is (31, N) int64 (1 GiB at 2^22
    lanes) -- never the (16, 16, N) outer product.
    """
    a64, b64 = a.to(_I64), b.to(_I64)
    cols = torch.zeros((31, a.shape[1]), dtype=_I64, device=a.device)
    for i in range(16):
        cols[i:i + 16] += a64[i] * b64
    r = _reduce_cols(cols, 16 * M16 * M16).to(torch.int32)
    for s in sub:
        r = submod(r, s)
    return r


def sqrmod(a: torch.Tensor, sub: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """(a^2 - sum(sub)) mod p, relaxed."""
    return mulmod(a, a, sub)


def canonicalize(x: torch.Tensor) -> torch.Tensor:
    """Relaxed (< 2^256) -> canonical (< p): subtract p when x + c
    carries out of 2^256."""
    x64 = x.to(_I64)
    s, o = _exact(_add_c(x64, torch.ones_like(x64[0])))
    return torch.where((o == 1)[None, :], s, x64).to(torch.int32)


def modinv(a: torch.Tensor) -> torch.Tensor:
    """Modular inverse mod p, canonical; inv(0) == 0.

    Exact, on the host: Python's pow(x, p - 2, p) per lane.  batch_inv
    calls it on the single root lane of its fold tree, so on a card this
    is one small copy each way instead of the thousands of tiny launches
    an eager-mode safegcd would take.
    """
    vals = limbs_to_ints_fast(a.cpu().numpy().astype(np.uint32))
    inv = [pow(int(v), P - 2, P) for v in vals]
    out = ints_to_limbs_fast(inv).astype(np.int32)
    return torch.from_numpy(out).to(a.device)


def batch_inv(a: torch.Tensor) -> torch.Tensor:
    """Invert all N lanes: ~3 multiplies per lane + one modinv.

    Fold tree (first half x second half) down to a single lane (or an
    odd width), invert that root exactly, then unfold.  A zero lane
    zeroes every lane whose tree path it shares; the walk never
    inverts zero.
    """
    levels = []
    cur = a
    while cur.shape[1] > 1 and cur.shape[1] % 2 == 0:
        half = cur.shape[1] // 2
        levels.append(cur)
        cur = mulmod(cur[:, :half], cur[:, half:])
    inv = modinv(cur)
    for lev in reversed(levels):
        half = lev.shape[1] // 2
        inv = mulmod(torch.cat([inv, inv], 1),
                     torch.cat([lev[:, half:], lev[:, :half]], 1))
    return inv


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane-wise equality of limb vectors -> bool (N,)."""
    return (a == b).all(0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(0)


def add_u128(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(d + e) mod 2^128 on (8, N) limb vectors (device distances)."""
    limbs, _ = _exact(d.to(_I64) + e.to(_I64))
    return limbs.to(torch.int32)


def _plus_one(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[0] += 1
    return x


def neg_u128(d: torch.Tensor) -> torch.Tensor:
    """Two's-complement negate mod 2^128 on (8, N) limb vectors (the
    signed distances of the symmetry walk): ~d + 1."""
    limbs, _ = _exact(_plus_one(M16 ^ d.to(_I64)))
    return limbs.to(torch.int32)


# y is in the high symmetry class iff canonical y > (p-1)/2, i.e. iff
# y + (2^256 - (p+1)/2) carries out of 2^256.
_HALF_TEST = (1 << 256) - ((P + 1) >> 1)


def y_is_high(y: torch.Tensor) -> torch.Tensor:
    """(N,) int32, 1 where canonical y > (p-1)/2: the lane's point is
    replaced by its negation, which keeps the smaller y (the class
    representative of {P, -P})."""
    _, o = _exact(y.to(_I64) + _limb_col(_HALF_TEST, 16, y.device))
    return o.to(torch.int32)


def neg_y(y: torch.Tensor) -> torch.Tensor:
    """(p - y) mod 2^256 on (16, N) limbs: for canonical 0 < y < p the
    canonical negation."""
    limbs, _ = _exact(_plus_one(_limb_col(P, 16, y.device)
                                + (M16 ^ y.to(_I64))))
    return limbs.to(torch.int32)
