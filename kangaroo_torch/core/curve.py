"""Exact host-side secp256k1 arithmetic over Python integers.

This is the cold path: jump-table construction, collision resolution,
key verification, pubkey parsing.  The hot path (the jump loop) lives in
`kangaroo_torch.ops` as tensor code and a CUDA kernel.  Python integers give
exact 256-bit arithmetic for free, so unlike the reference we do not
need a custom bignum for the host side (reference: SECPK1/Int.cpp,
SECPK1/SECP256K1.cpp -- semantics mirrored, representation redesigned).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

from ..constants import GX, GY, N_ORDER, P


@dataclass(frozen=True)
class PointA:
    """Affine point; None coordinates encode the identity."""

    x: Optional[int]
    y: Optional[int]

    @property
    def is_zero(self) -> bool:
        return self.x is None

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, PointA):
            return NotImplemented
        return self.x == other.x and self.y == other.y

    def neg(self) -> "PointA":
        if self.is_zero:
            return self
        return PointA(self.x, (P - self.y) % P)


ZERO = PointA(None, None)
G = PointA(GX, GY)


def mod_inv(a: int, m: int = P) -> int:
    if a == 0:
        return 0
    return pow(a, -1, m)


def add(p1: PointA, p2: PointA) -> PointA:
    """Affine point addition handling identity and doubling."""
    if p1.is_zero:
        return p2
    if p2.is_zero:
        return p1
    if p1.x == p2.x:
        if (p1.y + p2.y) % P == 0:
            return ZERO
        return double(p1)
    lam = ((p2.y - p1.y) * mod_inv((p2.x - p1.x) % P)) % P
    x3 = (lam * lam - p1.x - p2.x) % P
    y3 = (lam * (p1.x - x3) - p1.y) % P
    return PointA(x3, y3)


def double(p: PointA) -> PointA:
    if p.is_zero:
        return p
    if p.y == 0:
        return ZERO
    lam = (3 * p.x * p.x * mod_inv((2 * p.y) % P)) % P
    x3 = (lam * lam - 2 * p.x) % P
    y3 = (lam * (p.x - x3) - p.y) % P
    return PointA(x3, y3)


def mul(k: int, p: PointA = G) -> PointA:
    """Scalar multiplication k*P (double-and-add, host cold path)."""
    k %= N_ORDER
    r = ZERO
    q = p
    while k:
        if k & 1:
            r = add(r, q)
        k >>= 1
        q = double(q)
    return r


def compute_public_key(k: int) -> PointA:
    """k*G (reference: Secp256K1::ComputePublicKey, SECP256K1.cpp:59)."""
    return mul(k, G)


def on_curve(p: PointA) -> bool:
    """y^2 == x^3 + 7 (reference: Secp256K1::EC, SECP256K1.cpp:557)."""
    if p.is_zero:
        return False
    return (p.y * p.y - (p.x * p.x * p.x + 7)) % P == 0


def get_y(x: int, even: bool) -> int:
    """Lift x to y with given parity (reference: SECP256K1.cpp:536-554).

    p %% 4 == 3 so sqrt(a) = a^((p+1)/4).
    """
    a = (x * x * x + 7) % P
    y = pow(a, (P + 1) // 4, P)
    if (y * y - a) % P != 0:
        raise ValueError("x is not on the curve")
    if (y % 2 == 0) != even:
        y = P - y
    return y


def parse_public_key_hex(s: str) -> Tuple[PointA, bool]:
    """Parse 02/03/04-prefixed hex pubkey.

    Returns (point, is_compressed).
    Reference: Secp256K1::ParsePublicKeyHex, SECP256K1.cpp:140-201.
    """
    s = s.strip()
    if len(s) < 2:
        raise ValueError("invalid public key (too short)")
    prefix = int(s[0:2], 16)
    if prefix in (0x02, 0x03):
        if len(s) != 66:
            raise ValueError("invalid public key (66 character length)")
        x = int(s[2:66], 16)
        y = get_y(x, prefix == 0x02)
        pt = PointA(x, y)
        compressed = True
    elif prefix == 0x04:
        if len(s) != 130:
            raise ValueError("invalid public key (130 character length)")
        x = int(s[2:66], 16)
        y = int(s[66:130], 16)
        pt = PointA(x, y)
        compressed = False
    else:
        raise ValueError("invalid public key prefix (02, 03 or 04)")
    if not on_curve(pt):
        raise ValueError("point is not on the curve")
    return pt, compressed


def get_public_key_hex(p: PointA, compressed: bool = True) -> str:
    """Serialize pubkey (reference: SECP256K1.cpp:203-236)."""
    if compressed:
        prefix = "02" if p.y % 2 == 0 else "03"
        return (prefix + format(p.x, "064X")).upper()
    return ("04" + format(p.x, "064X") + format(p.y, "064X")).upper()


def batch_add(p1: List[PointA], p2: List[PointA]) -> List[PointA]:
    """Vector affine add accepting p1[i] == identity.

    Reference: vector Secp256K1::AddDirect, SECP256K1.cpp:265-322.  The
    reference batches the inversions (IntGroup); Python ints make a per
    element inversion acceptable on this cold path.
    """
    if len(p1) != len(p2):
        raise ValueError("batch_add: length mismatch")
    return [q if a.is_zero else add(a, q) for a, q in zip(p1, p2)]
