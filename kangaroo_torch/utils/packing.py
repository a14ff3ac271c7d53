"""Vectorized (de)serialization of herd state.

The port's copy of kangaroo_tpu/utils/packing.py (numpy only).  Work
files store one kangaroo as three little-endian 32-byte values (x,
canonical y, mod-n distance -- reference: SaveWork, Backup.cpp:449-572);
these helpers do the transforms as whole-array numpy passes, so that a
2^22-lane herd packs and unpacks without per-lane Python integers.

All bignum work runs on (L, N) int64 limb columns of 16-bit digits,
LSB-first -- the layout of the port's int32 device tensors (every limb
is below 2^16; convert at the boundary with
`t.cpu().numpy().astype(np.uint32)`) -- with one vectorized
carry-propagation pass per value (16 numpy ops over N lanes).
"""

from __future__ import annotations

import numpy as np

from ..constants import N_ORDER, P, TAME, WILD

_M16 = 0xFFFF
_M128 = (1 << 128) - 1


def _const_limbs(v: int, rows: int) -> np.ndarray:
    return np.array(
        [(v >> (16 * i)) & _M16 for i in range(rows)], dtype=np.int64
    )


_P_L = _const_limbs(P, 16)
_N_L = _const_limbs(N_ORDER, 16)
# c with p = 2^256 - c
_C = (1 << 256) - P
_NO_HALF = N_ORDER >> 1


def _carry(cols: np.ndarray, rows: int) -> np.ndarray:
    """Signed exact carry propagation; keeps `rows` limbs (drops the
    final carry/borrow -- callers guarantee the true value fits)."""
    out = np.empty((rows,) + cols.shape[1:], dtype=np.int64)
    c = np.zeros(cols.shape[1:], dtype=np.int64)
    for i in range(rows):
        t = (cols[i] if i < cols.shape[0] else 0) + c
        c = t >> 16
        out[i] = t & _M16
    return out


def _ge(a: np.ndarray, b_limbs: np.ndarray) -> np.ndarray:
    """Lane-wise a >= b for canonical 16-bit limb columns (same rows)."""
    rows = a.shape[0]
    res = np.ones(a.shape[1], dtype=bool)
    decided = np.zeros(a.shape[1], dtype=bool)
    for i in range(rows - 1, -1, -1):
        gt = a[i] > b_limbs[i]
        lt = a[i] < b_limbs[i]
        res = np.where(~decided & lt, False, res)
        decided = decided | gt | lt
    return res


def limbs_to_le_bytes(a: np.ndarray) -> np.ndarray:
    """(L, N) uint32 16-bit limbs -> (N, 2L) uint8 little-endian bytes."""
    a = np.ascontiguousarray(np.asarray(a).T.astype("<u2"))
    return a.view(np.uint8).reshape(a.shape[0], 2 * a.shape[1])


def le_bytes_to_limbs(buf: np.ndarray, rows: int) -> np.ndarray:
    """(N, 2*rows) uint8 -> (rows, N) uint32 16-bit limbs."""
    v = np.ascontiguousarray(buf).view("<u2").astype(np.uint32)
    return v.T.copy()


def canon_mod_p(y: np.ndarray) -> np.ndarray:
    """(16, N) relaxed limbs (< 2^256) -> canonical mod p, vectorized.

    y >= p  iff  y + c carries out of 2^256 (same test as the device's
    _cond_sub_p_arr); the reduced value is then the low 256 bits of
    y + c.
    """
    t = np.asarray(y, dtype=np.int64).copy()
    t[0] += _C & _M16
    t[2] += (_C >> 32) & _M16
    c = np.zeros(t.shape[1], dtype=np.int64)
    out = np.empty_like(t)
    for i in range(16):
        s = t[i] + c
        c = s >> 16
        out[i] = s & _M16
    return np.where(c[None, :] == 1, out, np.asarray(y, dtype=np.int64)).astype(
        np.uint32
    )


def dist_words(d: np.ndarray):
    """(8, N) 16-bit distance limbs -> their (N,) uint64 lo and hi words."""
    d = np.asarray(d).astype(np.uint64)
    return tuple(d[k] | (d[k + 1] << np.uint64(16))
                 | (d[k + 2] << np.uint64(32)) | (d[k + 3] << np.uint64(48))
                 for k in (0, 4))


def true_dist_limbs(
    d: np.ndarray, types: np.ndarray, width_div2: int, symmetry: bool
) -> np.ndarray:
    """(8, N) device distances -> (16, N) mod-n distances.

    Vectorized herd.true_distance: plain mode removes the +W/2 wild
    offset (mod n); symmetry mode sign-extends the 128-bit two's
    complement and reduces mod n.
    """
    d = np.asarray(d, dtype=np.int64)
    n = d.shape[1]
    cols = np.zeros((16, n), dtype=np.int64)
    cols[:8] = d
    if symmetry:
        neg = (d[7] >> 15) & 1  # bit 127
        k = _const_limbs(N_ORDER - (1 << 128), 16)
        cols += neg[None, :] * k[:, None]
        return _carry(cols, 16).astype(np.uint32)
    wild = (np.asarray(types, dtype=np.int64) & 1) == WILD
    w = _const_limbs(width_div2, 16)
    # d_dev >= W/2 ? plain subtract : subtract then add n
    w0 = np.uint64(width_div2 & ((1 << 64) - 1))
    w1 = np.uint64(width_div2 >> 64)
    du0, du1 = dist_words(d)
    ge = (du1 > w1) | ((du1 == w1) & (du0 >= w0))
    addn = wild & ~ge
    cols -= wild[None, :] * w[:, None]
    cols += addn[None, :] * _N_L[:, None]
    return _carry(cols, 16).astype(np.uint32)


def device_dist_limbs(
    dm: np.ndarray, types: np.ndarray, width_div2: int, symmetry: bool
) -> np.ndarray:
    """(16, N) mod-n distances (< 2^256) -> (8, N) device distances.

    Vectorized herd.device_distance.  Accepts any value < 2^256 (file
    contents), reducing mod n first exactly like the scalar path.
    """
    dm = np.asarray(dm, dtype=np.int64)
    if symmetry:
        # v = dm % N_ORDER: one conditional subtract covers all 256-bit
        # inputs (2^256 - 1 < 2*n)
        big = _ge(dm, _N_L)
        v = _carry(dm - big[None, :] * _N_L[:, None], 16)
        # v > n/2 -> v - n, two's complement mod 2^128
        high = _ge(v, _const_limbs(_NO_HALF + 1, 16))
        cols = v - high[None, :] * _N_L[:, None]
        return _carry(cols, 8).astype(np.uint32)
    # Plain mode matches herd.device_distance exactly: only wild lanes
    # go through the +W/2-then-mod-n path; tame lanes keep their raw
    # low 128 bits.
    wild = (np.asarray(types, dtype=np.int64) & 1) == WILD
    w = _const_limbs(width_div2, 17)
    n17 = _const_limbs(N_ORDER, 17)
    s = _carry(np.concatenate([dm, np.zeros_like(dm[:1])])
               + wild[None, :] * w[:, None], 17)
    over = _ge(s, n17) & wild
    s = _carry(s - over[None, :] * n17[:, None], 16)
    return s[:8].astype(np.uint32)


def pack_d128(dm: np.ndarray, types: np.ndarray) -> np.ndarray:
    """(16, N) mod-n distances -> (8, N) D-encoded 128-bit values.

    Vectorized hashtable.convert distance encoding: bit 127 = sign
    (distance > 2^255 stores n - d), bit 126 = kangaroo type, low 126
    bits = magnitude (HashTable::Convert, HashTable.cpp:75-100).
    """
    dm = np.asarray(dm, dtype=np.int64)
    sign = (dm[15] >> 15) & 1
    # (n - d) & M128: borrows flow upward, so the low 8 output limbs
    # depend only on the low 8 operand limbs (final borrow dropped)
    neg = _carry(_N_L[:8][:, None] - dm[:8], 8)
    mag = np.where(sign[None, :] == 1, neg, dm[:8])
    top = (mag[7] & 0x3FFF) | (sign << 15) | (
        (np.asarray(types, dtype=np.int64) & 1) << 14
    )
    out = mag.copy()
    out[7] = top
    return out.astype(np.uint32)


def d128_words(lo: np.ndarray, hi: np.ndarray, types: np.ndarray,
               width_div2: int, symmetry: bool):
    """Device distances as (N,) uint64 lo/hi words -> the lo/hi words of
    their D128 encoding: the true distance (d, or d - rangeWidth/2 on
    wild lanes; in symmetry mode the signed 128-bit d itself) as b127
    sign, b126 type, b125..0 magnitude.  The same values as pack_d128 of
    true_dist_limbs, in a few uint64 passes.  Raises ValueError when a
    magnitude needs more than 126 bits."""
    ktype = (np.asarray(types) & 1).astype(np.uint64)
    if symmetry:
        neg = (hi >> np.uint64(63)).astype(bool)
        vlo, vhi = lo, hi
    else:
        wlo = np.uint64(width_div2 & 0xFFFFFFFFFFFFFFFF)
        whi = np.uint64(width_div2 >> 64)
        wild = ktype == 1
        borrow = (lo < wlo).astype(np.uint64)
        below = (hi < whi) | ((hi == whi) & (lo < wlo))
        vlo = np.where(wild, lo - wlo, lo)
        vhi = np.where(wild, hi - whi - borrow, hi)
        neg = wild & below
    # |v| for negative values (two's-complement negate, 128 bits)
    mlo = (~vlo) + np.uint64(1)
    mhi = (~vhi) + (vlo == 0).astype(np.uint64)
    vlo = np.where(neg, mlo, vlo)
    vhi = np.where(neg, mhi, vhi)
    if (vhi >> np.uint64(62)).any():
        raise ValueError("distance magnitude exceeds 126 bits")
    return vlo, vhi | (ktype << np.uint64(62)) | (
        neg.astype(np.uint64) << np.uint64(63))


def unpack_d128(d128: np.ndarray):
    """(8, N) D-encoded values -> ((16, N) mod-n distances, (N,) types).

    Vectorized hashtable.calc_dist_and_type."""
    d128 = np.asarray(d128, dtype=np.int64)
    types = (d128[7] >> 14) & 1
    sign = (d128[7] >> 15) & 1
    mag = d128.copy()
    mag[7] &= 0x3FFF
    n = d128.shape[1]
    mag16 = np.zeros((16, n), dtype=np.int64)
    mag16[:8] = mag
    # sign: (n - mag) % n (mag == 0 stays 0)
    neg = _carry(_N_L[:, None] - mag16, 16)
    zero = (mag == 0).all(axis=0)
    out = np.where((sign == 1)[None, :], neg, mag16)
    out = np.where((sign == 1)[None, :] & zero[None, :], 0, out)
    return out.astype(np.uint32), types


def pack_kangaroos(
    px: np.ndarray,
    py: np.ndarray,
    d: np.ndarray,
    width_div2: int,
    symmetry: bool,
    first_type: int = TAME,
) -> bytes:
    """Herd arrays -> the reference's 96-byte kangaroo records.

    Layout per kangaroo: x[32] | canonical y[32] | mod-n dist[32],
    little-endian (SaveWork, Backup.cpp:449-572).  Kangaroo i's type is
    (i + first_type) % 2, the herd creation parity.
    """
    n = px.shape[1]
    types = (np.arange(n, dtype=np.int64) + first_type) & 1
    xb = limbs_to_le_bytes(px)
    yb = limbs_to_le_bytes(canon_mod_p(py))
    db = limbs_to_le_bytes(true_dist_limbs(d, types, width_div2, symmetry))
    rec = np.concatenate([xb, yb, db], axis=1)  # (N, 96)
    return rec.tobytes()


def unpack_kangaroos(
    buf: bytes, width_div2: int, symmetry: bool, first_type: int = TAME
):
    """96-byte records -> (px, py, d_device, dist_mod_n_limbs) arrays."""
    rec = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 96)
    n = rec.shape[0]
    px = le_bytes_to_limbs(rec[:, :32], 16)
    py = le_bytes_to_limbs(rec[:, 32:64], 16)
    dmod = le_bytes_to_limbs(rec[:, 64:96], 16)
    types = (np.arange(n, dtype=np.int64) + first_type) & 1
    d = device_dist_limbs(dmod, types, width_div2, symmetry)
    return px, py, d, dmod
