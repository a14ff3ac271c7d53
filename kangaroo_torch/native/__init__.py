"""Native (C++) runtime components, loaded via ctypes.

`merge_core.cpp` holds the DP hash table, its work-file bucket region
writer and reader, and the streamed work-file merge (the reference's
Merge.cpp / PartMerge.cpp).  It is compiled with g++ at first use into
the git-ignored build directory (see `utils.build`); a failed build
raises: the port has no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..utils.build import build_shared

_SRC = Path(__file__).resolve().parent / "merge_core.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build_shared(
            "libkangaroo_native.so", [_SRC],
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"], timeout=120,
        )
        lib = ctypes.CDLL(str(path))
        lib.kt_ht_new.restype = ctypes.c_void_p
        lib.kt_ht_new.argtypes = []
        lib.kt_ht_free.restype = None
        lib.kt_ht_free.argtypes = [ctypes.c_void_p]
        lib.kt_ht_reset.restype = None
        lib.kt_ht_reset.argtypes = [ctypes.c_void_p]
        lib.kt_ht_nitems.restype = ctypes.c_ulonglong
        lib.kt_ht_nitems.argtypes = [ctypes.c_void_p]
        lib.kt_ht_add_batch.restype = ctypes.c_longlong
        lib.kt_ht_add_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_ulonglong),
        ]
        lib.kt_ht_export.restype = ctypes.c_longlong
        lib.kt_ht_export.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
        ]
        lib.kt_ht_write.restype = ctypes.c_longlong
        lib.kt_ht_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_int,
        ]
        lib.kt_ht_write_span.restype = ctypes.c_longlong
        lib.kt_ht_write_span.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.kt_ht_read.restype = ctypes.c_longlong
        lib.kt_ht_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.kt_ht_stats.restype = ctypes.c_longlong
        lib.kt_ht_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)
        ]
        lib.kt_merge_buckets.restype = ctypes.c_longlong
        lib.kt_merge_buckets.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_ulonglong),
        ]
        lib.kt_count_buckets.restype = ctypes.c_longlong
        lib.kt_count_buckets.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_uint32
        ]
        lib.kt_scan_buckets.restype = ctypes.c_longlong
        lib.kt_scan_buckets.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        _lib = lib
        return _lib


MAX_COLLISIONS = 64


def merge_buckets(
    f1: str, off1: int, f2: str, off2: int, dest: str, dest_off: int,
    n_buckets: int,
) -> Tuple[int, int, List[Tuple[int, int]]]:
    """Streamed merge of n_buckets of two bucket regions into dest.

    Returns (total_dps, duplicates, [(d128_1, d128_2) collisions]).
    Every collision is reported: if the pair buffer overflows (the core
    counts all collisions in coll_total), the merge is re-run with a
    buffer sized to the exact count -- the re-run writes byte-identical
    dest output.  Raises IOError when the core fails.
    """
    lib = get_lib()
    max_coll = MAX_COLLISIONS
    while True:
        dup = ctypes.c_ulonglong(0)
        coll = (ctypes.c_uint8 * (32 * max_coll))()
        n_coll = ctypes.c_uint32(0)
        coll_total = ctypes.c_ulonglong(0)
        total = lib.kt_merge_buckets(
            f1.encode(), off1, f2.encode(), off2, dest.encode(), dest_off,
            n_buckets, ctypes.byref(dup), coll, ctypes.byref(n_coll),
            max_coll, ctypes.byref(coll_total),
        )
        if total < 0:
            raise IOError(f"native merge failed ({f1} + {f2} -> {dest})")
        if coll_total.value <= n_coll.value:
            break
        max_coll = int(coll_total.value)
    raw = bytes(coll)
    pairs = [(int.from_bytes(raw[32 * i:32 * i + 16], "little"),
              int.from_bytes(raw[32 * i + 16:32 * i + 32], "little"))
             for i in range(n_coll.value)]
    return int(total), int(dup.value), pairs


def scan_buckets(path: str, off: int, n_buckets: int):
    """Per-bucket (nbItem, maxItem) of a bucket region, as two (n,)
    uint32 arrays, by seeking past the entries (the reference's
    SeekNbItem).  Raises IOError when the region cannot be read."""
    nb = (ctypes.c_uint32 * n_buckets)()
    mx = (ctypes.c_uint32 * n_buckets)()
    if get_lib().kt_scan_buckets(path.encode(), off, n_buckets, nb, mx) < 0:
        raise IOError(f"cannot scan {n_buckets} buckets of {path} at {off}")
    return (np.frombuffer(nb, dtype=np.uint32).copy(),
            np.frombuffer(mx, dtype=np.uint32).copy())


def count_buckets(path: str, off: int, n_buckets: int) -> int:
    """Entries in n_buckets of a bucket region; raises IOError when the
    region cannot be read."""
    n = get_lib().kt_count_buckets(path.encode(), off, n_buckets)
    if n < 0:
        raise IOError(f"cannot count {n_buckets} buckets of {path} at {off}")
    return int(n)
