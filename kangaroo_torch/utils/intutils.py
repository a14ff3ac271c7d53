"""Conversions between Python ints and limb-vector arrays.

Vectorized 256-bit values are stored limbs-first as uint32 arrays of
shape (L, N): L limbs of 16 bits, least-significant first, N lanes.
Limbs-first keeps the lane (batch) dimension last, so every field op
is a short loop over L of full-width tensor operations, and in the
CUDA kernel neighbouring threads read neighbouring lanes of a limb row.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

from ..constants import LIMB_BITS, LIMB_MASK, NB_LIMB


def int_to_limbs(v: int, nb_limb: int = NB_LIMB) -> np.ndarray:
    """One value -> (nb_limb,) uint32 array of 16-bit limbs."""
    if v < 0:
        v &= (1 << (nb_limb * LIMB_BITS)) - 1
    out = np.empty(nb_limb, dtype=np.uint32)
    for i in range(nb_limb):
        out[i] = v & LIMB_MASK
        v >>= LIMB_BITS
    if v:
        raise OverflowError("value does not fit in limb vector")
    return out


def ints_to_limbs(vals: Iterable[int], nb_limb: int = NB_LIMB) -> np.ndarray:
    """Iterable of ints -> (nb_limb, N) uint32 array."""
    vals = list(vals)
    out = np.empty((nb_limb, len(vals)), dtype=np.uint32)
    for j, v in enumerate(vals):
        out[:, j] = int_to_limbs(v, nb_limb)
    return out


def limbs_to_int(a: np.ndarray) -> int:
    """(nb_limb,) array -> int."""
    v = 0
    for i in range(a.shape[0] - 1, -1, -1):
        v = (v << LIMB_BITS) | int(a[i])
    return v


def limbs_to_ints(a: np.ndarray) -> List[int]:
    """(nb_limb, N) array -> list of N ints."""
    a = np.asarray(a)
    out = [0] * a.shape[1]
    for i in range(a.shape[0] - 1, -1, -1):
        row = a[i]
        for j in range(a.shape[1]):
            out[j] = (out[j] << LIMB_BITS) | int(row[j])
    return out


def limbs_to_ints_fast(a: np.ndarray) -> np.ndarray:
    """(nb_limb, N) -> (N,) object array of Python ints, vectorized."""
    a = np.asarray(a, dtype=np.uint64)
    acc = np.zeros(a.shape[1], dtype=object)
    for i in range(a.shape[0] - 1, -1, -1):
        acc = (acc << LIMB_BITS) | a[i].astype(object)
    return acc


def ints_to_limbs_fast(vals, nb_limb: int = NB_LIMB) -> np.ndarray:
    """Sequence of ints -> (nb_limb, N) uint32, vectorized.

    Same output as ints_to_limbs: each value is serialized once with
    int.to_bytes and the byte buffer is reinterpreted as little-endian
    16-bit limbs (one Python call per value instead of one numpy object
    operation per limb).  Negative values are taken two's-complement over
    nb_limb*16 bits, like int_to_limbs.
    """
    full = (1 << (nb_limb * LIMB_BITS)) - 1
    raw = [int(v) for v in vals]
    if raw and (max(raw) > full or min(raw) < -(full + 1)):
        raise OverflowError("value does not fit in limb vector")
    nbytes = nb_limb * LIMB_BITS // 8
    buf = b"".join([(v & full).to_bytes(nbytes, "little") for v in raw])
    limbs = np.frombuffer(buf, dtype="<u2").reshape(len(raw), nb_limb)
    return np.ascontiguousarray(limbs.T, dtype=np.uint32)
