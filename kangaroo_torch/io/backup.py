"""Work-file save/load, byte-compatible with the reference and with
kangaroo_tpu/io/backup.py.

File formats (reference: Backup.cpp:368-572, HashTable.cpp:371-468),
all little-endian:

HEADW (full work file):
  u32 head=0xFA6A8001, u32 version=0,
  u32 dpSize, rangeStart[32B], rangeEnd[32B], key.x[32B], key.y[32B],
  u64 totalCount, f64 totalTime,
  2^18 buckets: { u32 nbItem, u32 maxItem, nbItem * (x[16B], d[16B]) },
  u64 nbKangaroo, then (if saved) nbKangaroo * (x[32B], y[32B], d[32B])

HEADK  (kangaroo only): head, version, u64 nbKangaroo, kangaroos
HEADKS (compressed):    head, version, u64 nbKangaroo, 16B D-encoded
                        distances (positions rebuilt on load)

256-bit values are serialized as 4 u64 words LSW-first, which matches
the in-memory layout fwrite'd by the reference.  The bucket region is
written and read by the native table (`NativeHashTable.write_region`,
`read_region`); herds are packed and unpacked as whole arrays
(`utils.packing`).  Herd arguments are (16, N) / (8, N) limb arrays,
numpy or torch (device tensors are copied to the host).
"""

from __future__ import annotations

import math
import os
import struct
import time
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..constants import H_PER_PART, HASH_SIZE, HEADK, HEADKS, HEADW, MERGE_PART
from ..core import curve
from ..core.hashtable import NativeHashTable
from ..utils import packing


def _w_u32(f, v):
    f.write(struct.pack("<I", v & 0xFFFFFFFF))


def _w_u64(f, v):
    f.write(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))


def _w_f64(f, v):
    f.write(struct.pack("<d", v))


def _w_int(f, v, nbytes):
    f.write(int(v).to_bytes(nbytes, "little"))


def _r_u32(f):
    return struct.unpack("<I", f.read(4))[0]


def _r_u64(f):
    return struct.unpack("<Q", f.read(8))[0]


def _r_f64(f):
    return struct.unpack("<d", f.read(8))[0]


def _r_int(f, nbytes):
    return int.from_bytes(f.read(nbytes), "little")


def _host(a) -> np.ndarray:
    """A limb array on the host (a tensor is copied from its device)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def split_file_name(base: str) -> str:
    """Unique -wsplit file name: base + reference-style timestamp.

    The reference's Timer::getTS has 1-second resolution; two saves
    completing within the same second would silently overwrite a split
    file whose table was already discarded (losing its DPs), so append
    a counter suffix whenever the name is taken.
    """
    name = base + "_" + time.strftime("%d%b%y_%H%M%S")
    if not os.path.exists(name):
        return name
    k = 1
    while os.path.exists(f"{name}_{k}"):
        k += 1
    return f"{name}_{k}"


def ref_max_item(nb: int) -> int:
    """maxItem as the reference's allocator would have left it.

    Buckets allocate 16 slots, then grow by 4 when nbItem hits
    maxItem-1 (HashTable.cpp:262-307).  Reproduced so files are
    byte-identical to reference solver output.
    """
    if nb == 0:
        return 0
    if nb <= 15:
        return 16
    return 4 * ((nb + 4) // 4)


def merge_max_item(nb: int) -> int:
    """maxItem as the reference's merge writes it (round up to 4)."""
    if nb % 4 == 0:
        return nb
    return ((nb // 4) + 1) * 4


# Version written for equivalence-class (-sym) walks.  Symmetric work
# files carry sign-flipped distances that plain-mode tooling would
# misinterpret, so they get their own version number: both our merge
# and the reference's reject version mismatches (Merge.cpp:108-143),
# keeping version-0 files fully interoperable with the stock binary.
SYM_VERSION = 1

# Size of a full HEADW header: magic+version+dp (12) + 4x32-byte values
# (128) + count (8) + time (8).
HEADW_HEADER_SIZE = 156


def write_header(f, head_type: int, solver=None, total_count: int = 0,
                 total_time: float = 0.0, symmetry: bool = False):
    _w_u32(f, head_type)
    _w_u32(f, SYM_VERSION if symmetry else 0)
    if head_type == HEADW:
        key = solver.cfg.keys[solver.key_idx]
        _w_u32(f, solver.dp_size)
        _w_int(f, solver.range_start, 32)
        _w_int(f, solver.range_end, 32)
        _w_int(f, key.x, 32)
        _w_int(f, key.y, 32)
        _w_u64(f, total_count)
        _w_f64(f, total_time)


def write_hash_table(f, ht: NativeHashTable, max_item_fn=ref_max_item):
    """Serialize the table in reference bucket order at the stream's
    position, from C++ (seconds, not minutes, at 10^7 DPs), and advance
    the stream past the region.

    A drain that runs meanwhile (background saves) waits for one span
    of buckets at most: entries inserted mid-save land in this file or
    the next (a fuzzy snapshot, the loss class of the reference's save
    interval).
    """
    f.flush()
    written = ht.write_region(f.name, f.tell(),
                              merge_style=max_item_fn is merge_max_item)
    f.seek(f.tell() + written)


def save_work(
    path: str,
    solver,
    px,
    py,
    d,
    total_count: int,
    total_time: float,
    save_kangaroo: bool = False,
    table: Optional[NativeHashTable] = None,
):
    """Full HEADW work file (reference: SaveWork, Backup.cpp:449-572).

    px/py are (16, N) limb arrays, d the (8, N) device distances; the
    on-file distance is the mod-n value (wild offset removed), exactly
    like GPUEngine::GetKangaroos (GPUEngine.cu:474-480).  `table`
    overrides solver.hash_table (background saves pass the table of the
    save request).  Written to path + ".tmp" and renamed into place.
    """
    sym = bool(solver.opts.symmetry)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_header(f, HEADW, solver, total_count, total_time, symmetry=sym)
        write_hash_table(f, table if table is not None else solver.hash_table)
        if save_kangaroo and px is not None:
            px = _host(px)
            _w_u64(f, px.shape[1])
            f.write(packing.pack_kangaroos(px, _host(py), _host(d),
                                           solver.width_div2, sym))
        else:
            _w_u64(f, 0)
    os.replace(tmp, path)


@dataclass
class LoadedWork:
    dp_size: int
    range_start: int
    range_end: int
    key: curve.PointA
    count: int
    time: float
    hash_table: NativeHashTable
    nb_kangaroo: int
    # (px, py, d_device) uint32 limb arrays of the saved herd, or None
    kangaroos: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    # True when the file was written by an equivalence-class (-sym) walk
    symmetry: bool = False


def read_header(f, expect: Optional[int] = None) -> Tuple[int, int]:
    """Read (head magic, version)."""
    head = _r_u32(f)
    version = _r_u32(f)
    if expect is not None and head != expect:
        raise ValueError(f"unexpected work file header 0x{head:08X}")
    return head, version


def load_work(path: str, load_kangaroos: bool = True) -> LoadedWork:
    """Load a HEADW work file (reference: LoadWork, Backup.cpp:149-207).

    The bucket region streams straight into a native table
    (kt_ht_read): a 10^7-DP resume costs about a second.  The herd is
    unpacked as whole arrays.
    """
    with open(path, "rb") as f:
        _, version = read_header(f, HEADW)
        sym = version == SYM_VERSION
        dp = _r_u32(f)
        range_start = _r_int(f, 32)
        range_end = _r_int(f, 32)
        kx = _r_int(f, 32)
        ky = _r_int(f, 32)
        count = _r_u64(f)
        ttime = _r_f64(f)
        key = curve.PointA(kx, ky)
        if not curve.on_curve(key):
            raise ValueError("LoadWork: key does not lie on elliptic curve")
        ht = NativeHashTable()
        off = f.tell()
        f.seek(off + ht.read_region(path, off))
        # Merged files end right after the hash table (no kangaroo
        # count, Merge.cpp:194-214); treat EOF as zero kangaroos.
        raw = f.read(8)
        nb = int.from_bytes(raw, "little") if len(raw) == 8 else 0
        kang = None
        if nb and load_kangaroos:
            px, py, d, _ = packing.unpack_kangaroos(
                f.read(96 * nb), (range_end - range_start) >> 1, sym)
            kang = (px, py, d)
    return LoadedWork(dp, range_start, range_end, key, count, ttime, ht, nb,
                      kang, symmetry=sym)


def read_bucket_entries(path: str, off: int, n_buckets: int, batch: int,
                        h_base: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
    """The entries of a bucket region as numpy columns, whole buckets at
    a time, about `batch` entries per yield: (h (m,) uint32 bucket ids
    from h_base, x (m, 2) uint64 lo/hi of X128, d (m, 2) uint64 lo/hi of
    D128).  Bucket counts come from a native scan; each chunk is one
    read, parsed without a per-entry loop."""
    nb, _ = native.scan_buckets(path, off, n_buckets)
    ends = np.cumsum(nb, dtype=np.int64)
    with open(path, "rb") as f:
        b0 = 0
        while b0 < n_buckets:
            done = int(ends[b0 - 1]) if b0 else 0
            b1 = int(np.searchsorted(ends, done + batch, side="left")) + 1
            b1 = min(max(b1, b0 + 1), n_buckets)
            m = int(ends[b1 - 1]) - done
            start = off + 8 * b0 + 32 * done
            f.seek(start)
            raw = f.read(8 * (b1 - b0) + 32 * m)
            if len(raw) != 8 * (b1 - b0) + 32 * m:
                raise IOError(f"{path}: bucket region ends early")
            if m:
                words = np.frombuffer(raw, dtype="<u8")
                local = np.repeat(np.arange(b1 - b0, dtype=np.int64),
                                  nb[b0:b1].astype(np.int64))
                # each bucket is one header word then 4 words per entry
                w = (local + 1) + 4 * np.arange(m, dtype=np.int64)
                yield ((local + b0 + h_base).astype(np.uint32),
                       np.stack([words[w], words[w + 1]], axis=1),
                       np.stack([words[w + 2], words[w + 3]], axis=1))
            b0 = b1


def save_kangaroo_file(
    path: str, solver, px, py, d, total_count: int, total_time: float,
    compressed: bool = False,
):
    """HEADK / HEADKS kangaroo-only files (client side -w / -wss)."""
    sym = bool(solver.opts.symmetry)
    px, py, d = _host(px), _host(py), _host(d)
    n = px.shape[1]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_header(f, HEADKS if compressed else HEADK, None,
                     total_count, total_time, symmetry=sym)
        _w_u64(f, n)
        if compressed:
            f.write(d128_records(d, solver.width_div2, sym).tobytes())
        else:
            f.write(packing.pack_kangaroos(px, py, d, solver.width_div2,
                                           sym))
    os.replace(tmp, path)


def d128_records(d, width_div2: int, symmetry: bool) -> np.ndarray:
    """(8, N) device distances -> (N, 16) uint8: each kangaroo's 16-byte
    D encoding, its type from its lane's parity (the vectorized
    convert(0, dist, i % 2) per lane), as HEADKS files and the -wss
    exchange store them."""
    lo, hi = packing.dist_words(_host(d))
    n = len(lo)
    words = np.empty((n, 2), dtype="<u8")
    words[:, 0], words[:, 1] = packing.d128_words(
        lo, hi, np.arange(n) & 1, width_div2, symmetry)
    return words.view(np.uint8).reshape(n, 16)


def load_kangaroo_file(
    path: str,
    range_start: int,
    range_end: int,
    key_to_search: Optional[curve.PointA],
    symmetry: bool = False,
    device="cuda",
):
    """Load a HEADK/HEADKS kangaroo-only file -> (px, py, d_dev) uint32
    limb arrays.

    HEADK stores (x, y, dist) triplets; HEADKS stores only the 16-byte
    D-encoded distance of each kangaroo, and the positions are rebuilt
    on `device` (rebuild_from_d128).
    """
    with open(path, "rb") as f:
        head, version = read_header(f)
        if head not in (HEADK, HEADKS):
            raise ValueError(f"{path}: not a kangaroo-only file")
        sym = version == SYM_VERSION
        if sym != symmetry:
            raise ValueError(
                f"{path}: kangaroo file was saved "
                f"{'with' if sym else 'without'} -sym; rerun "
                f"{'with' if sym else 'without'} -sym to resume it"
            )
        nb = _r_u64(f)
        width_div2 = (range_end - range_start) >> 1
        if head == HEADK:
            px, py, d, _ = packing.unpack_kangaroos(
                f.read(96 * nb), width_div2, sym)
            return px, py, d
        d128 = packing.le_bytes_to_limbs(
            np.frombuffer(f.read(16 * nb), dtype=np.uint8).reshape(nb, 16),
            8)
    return rebuild_from_d128(d128, range_start, range_end, key_to_search,
                             symmetry=sym, device=device)


def rebuild_from_d128(
    d128,
    range_start: int,
    range_end: int,
    key_to_search: Optional[curve.PointA],
    symmetry: bool = False,
    device="cuda",
):
    """D-encoded distances -> (px, py, d_dev) uint32 limb arrays.

    d128: (8, N) limbs of the 16-byte D encoding, or a sequence of
    Python ints.  Positions are rebuilt on `device` with the batched
    scalar multiply (dist*G, plus keyToSearch for wild entries), like
    the reference's compressed fetch (FetchWalks, Backup.cpp:233-289);
    the multiply runs over the bytes of the 126-bit magnitude and
    negates y for a signed distance (ec.signed_mult_base): the same
    points.

    Symmetry mode additionally normalizes each rebuilt point into its
    equivalence class (y <= p/2, negating the distance on flip) exactly
    like herd creation (Kangaroo.cpp:726-734), on the device, for all
    lanes at once; symClass restarts at 0, matching the reference's
    restore (FetchWalks reallocates symClass zeroed).
    """
    from ..core.solver import resolve_device
    from ..ops import ec, field
    from ..utils.intutils import ints_to_limbs_fast

    dev = resolve_device(str(device))
    if not isinstance(d128, np.ndarray):
        d128 = ints_to_limbs_fast(d128, 8)
    d128 = np.asarray(d128, dtype=np.int64)
    n = d128.shape[1]
    width_div2 = (range_end - range_start) >> 1
    dmod, types = packing.unpack_d128(d128)
    # |d| is the low 126 bits; the sign bit stores n - |d|
    mag = np.zeros((16, n), dtype=np.int32)
    mag[:8] = d128
    mag[7] &= 0x3FFF
    neg = ((d128[7] >> 15) & 1) == 1
    wild = types == 1
    sx, sy, zero = ec.signed_mult_base(
        torch.from_numpy(mag).to(dev), torch.from_numpy(neg).to(dev),
        ec.windows_for(mag))
    if wild.any():
        if key_to_search is None:
            raise ValueError("compressed wild kangaroos need the key")
        ax, ay = ec.add_point(sx, sy, zero, key_to_search)
        sel = torch.from_numpy(wild).to(dev)[None, :]
        sx, sy = torch.where(sel, ax, sx), torch.where(sel, ay, sy)
    ddev = torch.from_numpy(packing.device_dist_limbs(
        dmod, types, width_div2, symmetry).astype(np.int32)).to(dev)
    if symmetry:
        flip = (field.y_is_high(sy) == 1)[None, :]
        sy = torch.where(flip, field.neg_y(sy), sy)
        ddev = torch.where(flip, field.neg_u128(ddev), ddev)
    return tuple(t.cpu().numpy().astype(np.uint32) for t in (sx, sy, ddev))


def get_time_str(s: float) -> str:
    """Duration formatting of the reference (Thread.cpp GetTimeStr)."""
    nb_day = s / 86400.0
    if nb_day >= 1:
        nb_year = nb_day / 365.0
        if nb_year > 1:
            if nb_year < 5:
                return f"{nb_year:.1f}y"
            return f"{nb_year:g}y"
        return f"{nb_day:.1f}d"
    it = int(s)
    h, m, sec = it // 3600, (it % 3600) // 60, it % 60
    if h == 0:
        if m == 0:
            return f"{sec:02d}s"
        return f"{m:02d}:{sec:02d}"
    return f"{h:02d}:{m:02d}:{sec:02d}"


def _ht_info_lines(nb: np.ndarray, mx: np.ndarray):
    """HashTable::PrintInfo fields from per-bucket counts
    (HashTable.cpp:470-511 + GetSizeInfo :326-357)."""
    count = int(nb.sum())
    avg = count / HASH_SIZE
    max_i = int(np.argmax(nb))
    min_i = int(np.argmin(nb))
    sdev = float(np.sqrt(np.mean((avg - nb.astype(np.float64)) ** 2)))
    # reference struct sizes: HASH_ENTRY 16 B, ENTRY* 8 B, ENTRY 32 B
    total_b = 16 * HASH_SIZE + int(8 * mx.astype(np.int64).sum()) + 32 * count
    used_b = 8 * HASH_SIZE + 32 * count
    unit = "MB"
    total_u = total_b / (1024.0 * 1024.0)
    used_u = used_b / (1024.0 * 1024.0)
    for u in ("GB", "TB"):
        if total_u > 1024:
            total_u /= 1024
            used_u /= 1024
            unit = u
    return [
        f"DP Size   : {used_u:.1f}/{total_u:.1f}{unit}",
        f"DP Count  : {count} 2^{math.log2(count) if count else 0:.3f}",
        f"HT Max    : {int(nb[max_i])} [@ {max_i:06X}]",
        f"HT Min    : {int(nb[min_i])} [@ {min_i:06X}]",
        f"HT Avg    : {avg:.2f}",
        f"HT SDev   : {sdev:.2f}",
    ]


def work_info(path: str) -> str:
    """-winfo: header + hash table stats, for plain work files and
    256-partition directories (reference: WorkInfo, Backup.cpp:574-652
    incl. the IsDir dispatch)."""
    from . import merge as merge_mod

    is_dir = os.path.isdir(path)
    header_path = os.path.join(path, "header") if is_dir else path
    with open(header_path, "rb") as f:
        head, version = read_header(f)
        lines = []
        if head == HEADW:
            dp = _r_u32(f)
            range_start = _r_int(f, 32)
            range_end = _r_int(f, 32)
            kx = _r_int(f, 32)
            ky = _r_int(f, 32)
            count = _r_u64(f)
            ttime = _r_f64(f)
            key = curve.PointA(kx, ky)
            if not curve.on_curve(key):
                raise ValueError(
                    "WorkInfo: key1 does not lie on elliptic curve"
                )
            lines.append(f"Version   : {version}")
            lines.append(f"DP bits   : {dp}")
            lines.append(f"Start     : {range_start:X}")
            lines.append(f"Stop      : {range_end:X}")
            lines.append(
                "Key       : " + curve.get_public_key_hex(key, True)
            )
            lines.append(
                f"Count     : {count} "
                f"2^{math.log2(count) if count else 0:.3f}"
            )
            lines.append(f"Time      : {get_time_str(ttime)}")
            if is_dir:
                parts = [
                    native.scan_buckets(
                        merge_mod.part_name(path, p), 0, H_PER_PART
                    )
                    for p in range(MERGE_PART)
                ]
                nb = np.concatenate([a for a, _ in parts])
                mxs = np.concatenate([b for _, b in parts])
                nbk = 0
            else:
                table_off = f.tell()
                nb, mxs = native.scan_buckets(path, table_off, HASH_SIZE)
                f.seek(
                    table_off + 8 * HASH_SIZE + 32 * int(nb.sum())
                )
                raw = f.read(8)  # absent in merged files (Merge.cpp:194)
                nbk = int.from_bytes(raw, "little") if len(raw) == 8 else 0
            lines.extend(_ht_info_lines(nb, mxs))
            lines.append(
                f"Kangaroos : {nbk} "
                f"2^{math.log2(nbk) if nbk else 0:.3f}"
            )
        elif head in (HEADK, HEADKS):
            nb = _r_u64(f)
            kind = "compressed kangaroo" if head == HEADKS else "kangaroo"
            lines.append(
                f"{kind} only file "
                f"[2^{math.log2(nb) if nb else 0:.2f} kangaroos]"
            )
        else:
            raise ValueError(f"not a work file (head 0x{head:08X})")
    return "\n".join(lines)
