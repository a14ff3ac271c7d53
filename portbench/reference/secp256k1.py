"""secp256k1 in plain Python integers: the benchmark's own curve.

The field prime, the order and the generator are the curve's published
constants (SEC 2, section 2.4.1).  Points are affine (x, y) tuples and
None is the point at infinity.  Scalar multiples of G run in Jacobian
coordinates over a table of 2^i * G, with one inversion at the end.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
HALF_P = (P - 1) // 2

Point = Optional[Tuple[int, int]]

_POW2_G: List[Tuple[int, int]] = []


def on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 7) % P == 0


def neg(pt: Point) -> Point:
    return None if pt is None else (pt[0], (-pt[1]) % P)


def add(a: Point, b: Point) -> Point:
    """Affine a + b, every case."""
    if a is None:
        return b
    if b is None:
        return a
    (x1, y1), (x2, y2) = a, b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _jac_double(X, Y, Z):
    if Y == 0:
        return 0, 1, 0
    YY = Y * Y % P
    S = 4 * X * YY % P
    M = 3 * X * X % P
    X3 = (M * M - 2 * S) % P
    return X3, (M * (S - X3) - 8 * YY * YY) % P, 2 * Y * Z % P


def _jac_add_affine(X, Y, Z, x2, y2):
    """Jacobian (X, Y, Z) + affine (x2, y2)."""
    if Z == 0:
        return x2, y2, 1
    ZZ = Z * Z % P
    U2 = x2 * ZZ % P
    S2 = y2 * ZZ * Z % P
    H = (U2 - X) % P
    R = (S2 - Y) % P
    if H == 0:
        if R == 0:
            return _jac_double(X, Y, Z)
        return 0, 1, 0
    HH = H * H % P
    HHH = H * HH % P
    V = X * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    return X3, (R * (V - X3) - Y * HHH) % P, Z * H % P


def _pow2_table() -> List[Tuple[int, int]]:
    if not _POW2_G:
        pt = G
        for _ in range(256):
            _POW2_G.append(pt)
            pt = add(pt, pt)
    return _POW2_G


def mul_g(k: int) -> Point:
    """k * G for any integer k (taken mod N)."""
    k %= N
    table = _pow2_table()
    X, Y, Z = 0, 1, 0
    i = 0
    while k:
        if k & 1:
            X, Y, Z = _jac_add_affine(X, Y, Z, *table[i])
        k >>= 1
        i += 1
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def mul_g_many(ks: Sequence[int]) -> List[Point]:
    return [mul_g(k) for k in ks]


def compressed_hex(pt: Tuple[int, int]) -> str:
    """SEC 1 compressed encoding, upper-case hex (the reference's key
    file format)."""
    return f"{2 + (pt[1] & 1):02X}{pt[0]:064X}"
