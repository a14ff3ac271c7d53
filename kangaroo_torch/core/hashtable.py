"""Distinguished-point hash table with the reference's entry encoding.

Entry layout (reference: HashTable.h:51-56, HashTable::Convert
HashTable.cpp:75-100):
  * bucket  h = bits 128..145 of x  (x.bits64[2] & 0x3FFFF)
  * stored X = low 128 bits of x
  * stored D = 128-bit field: b127 = sign, b126 = kangaroo type,
    b125..b0 = |distance| (distance taken mod n; "negative" when the
    top bit of the 256-bit mod-n value is set, i.e. d > n/2)

The table itself is native C++ (`native/merge_core.cpp`): 2^18 buckets
of sorted 32-byte entries with the reference's Add semantics
(HashTable.cpp:262-307), taking whole drained batches in one call and
writing and reading the work-file bucket region natively.  The port has
no counterpart of the JAX package's dict table (`HashTable`, its
fallback when no C++ compiler is found): g++ is a requirement of the
port, which builds this library at first use and raises if it cannot.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, Tuple

import numpy as np

from ..constants import HASH_MASK, HASH_SIZE, N_ORDER
from ..utils import packing

_MASK128 = (1 << 128) - 1
_MASK126 = (1 << 126) - 1


def convert(x: int, d_modn: int, ktype: int) -> Tuple[int, int, int]:
    """(x, mod-n distance, type) -> (bucket h, X128, D128).

    Reference: HashTable::Convert (HashTable.cpp:75-100).
    """
    h = (x >> 128) & HASH_MASK
    x128 = x & _MASK128
    sign = 0
    if (d_modn >> 255) & 1:
        # "negative" distance: store n - d with the sign bit
        mag = (N_ORDER - d_modn) & _MASK128
        sign = 1 << 127
    else:
        mag = d_modn & _MASK128
    d128 = (mag & _MASK126) | sign | (ktype & 1) << 126
    return h, x128, d128


def calc_dist_and_type(d128: int) -> Tuple[int, int]:
    """Stored D128 -> (mod-n distance, type).

    Reference: HashTable::CalcDistAndType (HashTable.cpp:249-260).
    """
    ktype = (d128 >> 126) & 1
    sign = (d128 >> 127) & 1
    mag = d128 & _MASK126
    if sign:
        return (N_ORDER - mag) % N_ORDER, ktype
    return mag, ktype


def encode_records(blk: np.ndarray, width_div2: int, symmetry: bool):
    """A tick's DPs, (m, 20) int32 rows [x limbs 0..9 | device d limbs
    0..7 | step | global lane] (parallel/sharding.compact), as records
    {u32 h, x128, d128} (add_batch_raw): convert of x, the lane's true
    distance mod n (d, or d - width_div2 on wild lanes; with symmetry
    the signed 128-bit d) and its parity.  Returns ((m, 36) uint8
    records, int64 lanes) in walk order (step, then lane)."""
    order = np.lexsort((blk[:, 19], blk[:, 18]))
    blk = blk[order]
    lanes = blk[:, 19].astype(np.int64)
    m = len(lanes)
    xl = blk[:, 0:10].astype(np.uint32)
    lo, hi = packing.dist_words(blk[:, 10:18].T)
    words = np.empty((m, 2), dtype="<u8")
    words[:, 0], words[:, 1] = packing.d128_words(lo, hi, lanes, width_div2,
                                                  symmetry)
    rec = np.empty((m, 36), dtype=np.uint8)
    hbk = xl[:, 8] | ((xl[:, 9] & 0x3) << 16)
    rec[:, 0:4] = hbk.astype("<u4").view(np.uint8).reshape(m, 4)
    rec[:, 4:20] = xl[:, :8].astype("<u2").view(np.uint8).reshape(m, 16)
    rec[:, 20:36] = words.view(np.uint8)
    return rec, lanes


class NativeHashTable:
    """C++-backed DP table.

    Inserts take whole drained batches of packed 36-byte records in one
    call; every duplicate and collision of the batch is reported back.
    """

    #: records per native call: report buffers are sized to the chunk,
    #: so every duplicate/collision is always reported (a dropped
    #: collision pair could silently lose a solving tame/wild pair)
    CALL_CHUNK = 65536

    def __init__(self):
        from .. import native as native_mod

        self._lib = native_mod.get_lib()
        self._h = self._lib.kt_ht_new()
        # ctypes releases the GIL during calls: serialize native calls
        self._mu = threading.Lock()

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.kt_ht_free(self._h)
            self._h = None

    def reset(self) -> None:
        with self._mu:
            self._lib.kt_ht_reset(self._h)

    def n_items(self) -> int:
        with self._mu:
            return int(self._lib.kt_ht_nitems(self._h))

    def add_batch_raw(self, recs: bytes, n: int):
        """Insert n packed 36-byte records {u32 h, x128, d128} (LE).

        Returns (added, dup_indices, dup_total, collisions) where
        collisions is a list of (x128, d_new128, d_old128, index).
        """
        if n == 0:
            return 0, [], 0, []
        added_total = 0
        dups: list = []
        dup_sum = 0
        pairs: list = []
        for base in range(0, n, self.CALL_CHUNK):
            m = min(self.CALL_CHUNK, n - base)
            dup_idx = (ctypes.c_uint32 * m)()
            n_dup = ctypes.c_uint32(0)
            dup_total = ctypes.c_ulonglong(0)
            coll = (ctypes.c_uint8 * (52 * m))()
            n_coll = ctypes.c_uint32(0)
            coll_total = ctypes.c_ulonglong(0)
            with self._mu:
                added = self._lib.kt_ht_add_batch(
                    self._h, recs[36 * base:36 * (base + m)], m,
                    dup_idx, ctypes.byref(n_dup), m,
                    ctypes.byref(dup_total),
                    coll, ctypes.byref(n_coll), m,
                    ctypes.byref(coll_total),
                )
            if added < 0:
                raise ValueError("native add_batch: malformed bucket id")
            # buffers hold one report per record, so nothing is dropped
            if (coll_total.value != n_coll.value
                    or dup_total.value != n_dup.value):
                raise RuntimeError("native add_batch dropped a report")
            added_total += int(added)
            dup_sum += int(dup_total.value)
            dups.extend(base + i for i in dup_idx[: n_dup.value])
            raw = bytes(coll)
            for i in range(n_coll.value):
                o = 52 * i
                pairs.append((
                    int.from_bytes(raw[o:o + 16], "little"),
                    int.from_bytes(raw[o + 16:o + 32], "little"),
                    int.from_bytes(raw[o + 32:o + 48], "little"),
                    base + int.from_bytes(raw[o + 48:o + 52], "little"),
                ))
        return added_total, dups, dup_sum, pairs

    def export(self) -> bytes:
        """All entries in file order (bucket asc, x asc) as 36-byte
        records {u32 h, x128, d128}."""
        with self._mu:
            n = int(self._lib.kt_ht_nitems(self._h))
            buf = (ctypes.c_uint8 * (36 * n))()
            k = self._lib.kt_ht_export(self._h, buf)
        if k != n:
            raise RuntimeError(f"native export returned {k} of {n} records")
        return bytes(buf)

    def export_arrays(self):
        """All entries in file order as numpy columns (h, xlo, xhi,
        dlo, dhi): the u32/u64 halves of the 36-byte export records."""
        a = np.frombuffer(self.export(), dtype=np.uint8).reshape(-1, 36)
        h = a[:, 0:4].copy().view("<u4").ravel()
        x = a[:, 4:20].copy().view("<u8")    # (n, 2) lo/hi
        dd = a[:, 20:36].copy().view("<u8")  # (n, 2) lo/hi
        return h, x[:, 0], x[:, 1], dd[:, 0], dd[:, 1]

    def iter_sorted(self) -> Iterator[Tuple[int, int, int]]:
        """Yield (h, X128, D128) in file order (bucket asc, X asc)."""
        h, xlo, xhi, dlo, dhi = self.export_arrays()
        x = (xhi.astype(object) << 64) | xlo
        d = (dhi.astype(object) << 64) | dlo
        for i in range(len(h)):
            yield int(h[i]), int(x[i]), int(d[i])

    def absorb(self, other: "NativeHashTable") -> None:
        """Insert every entry of another table, in its file order."""
        raw = other.export()
        self.add_batch_raw(raw, len(raw) // 36)

    def stats(self):
        """(n_items, min, max, avg) bucket sizes; min and max over the
        non-empty buckets, avg over all HASH_SIZE."""
        nb = (ctypes.c_uint32 * HASH_SIZE)()
        with self._mu:
            total = int(self._lib.kt_ht_stats(self._h, nb))
        if total <= 0:
            return 0, 0, 0, 0.0
        arr = np.frombuffer(nb, dtype=np.uint32)
        nz = arr[arr > 0]
        return total, int(nz.min()), int(nz.max()), total / HASH_SIZE

    #: buckets serialized per hold of the table lock in write_region: a
    #: drain that runs while a background save writes waits for at most
    #: one span (1/32 of the table), never for the whole file (a fuzzy
    #: snapshot; -wsplit freezes the table first, so its files are exact)
    WRITE_SPAN = 1 << 13

    def write_region(self, path: str, off: int, merge_style: bool = False
                     ) -> int:
        """Write the HEADW bucket region at byte `off` of `path`, span by
        span; maxItem as the reference solver (merge_style False) or
        merge (True) leaves it.  Returns the bytes written."""
        style = 1 if merge_style else 0
        total = 0
        for hb0 in range(0, HASH_SIZE, self.WRITE_SPAN):
            hb1 = min(hb0 + self.WRITE_SPAN, HASH_SIZE)
            with self._mu:
                w = self._lib.kt_ht_write_span(
                    self._h, path.encode(), off + total, style, hb0, hb1)
            if w < 0:
                raise IOError(f"native table write failed: {path}")
            total += int(w)
        return total

    def read_region(self, path: str, off: int) -> int:
        """Replace the contents by the HEADW bucket region at byte `off`
        of `path`; returns the bytes consumed."""
        with self._mu:
            r = self._lib.kt_ht_read(self._h, path.encode(), off)
        if r < 0:
            raise IOError(f"native table read failed: {path}")
        return int(r)


def make_hash_table() -> NativeHashTable:
    """A new, empty DP table (always the native one in the port)."""
    return NativeHashTable()
