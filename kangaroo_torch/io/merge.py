"""Work-file merging: 2-file merge, directory fold-merge, 256-partition
merges -- byte-compatible with the reference formats and with
kangaroo_tpu/io/merge.py.

Reference semantics:
  * MergeWork (Merge.cpp:33-247): header compat checks (version, range,
    key), dest dp = min(dp1,dp2), per-bucket streamed sorted merge;
    equal x + equal d => duplicate ("dead kangaroo"), equal x +
    different d => collision -> solve the key and stop (no dest file).
  * MergeDir (Merge.cpp:255-343): collect work files of a directory,
    sort by size descending, fold-merge into dest.
  * Partitioned work dirs (PartMerge.cpp): a directory holding `header`
    (HEADW header only) and part000..part255, each covering
    HASH_SIZE/256 consecutive buckets in hashtable dump format.

The bucket merges run in the native core (`native.merge_buckets`); the
port has no pure-Python merge (g++ is a requirement of the port).  The
solve-during-merge path reuses core.collision.collision_check with the
key/range taken from the file headers.
"""

from __future__ import annotations

import os
import shutil
import struct
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import BinaryIO, Optional, Tuple

from .. import native
from ..constants import H_PER_PART, HASH_SIZE, HEADW, MERGE_PART, N_ORDER
from ..core import curve
from ..core.collision import SolveResult, collision_check
from ..core.hashtable import calc_dist_and_type
from . import backup
from .backup import (HEADW_HEADER_SIZE, _r_f64, _r_int, _r_u32, _r_u64,
                     _w_f64, _w_int, _w_u32, _w_u64)


@dataclass
class WorkHeader:
    dp: int
    range_start: int
    range_end: int
    key: curve.PointA
    count: int
    time: float
    # 0 = reference-compatible; SYM_VERSION = -sym walk (see backup.py)
    version: int = 0


def read_work_header(f: BinaryIO, path: str = "") -> WorkHeader:
    """Read a full HEADW header (magic+version+globals)."""
    _, version = backup.read_header(f, HEADW)
    dp = _r_u32(f)
    rs = _r_int(f, 32)
    re = _r_int(f, 32)
    kx = _r_int(f, 32)
    ky = _r_int(f, 32)
    count = _r_u64(f)
    t = _r_f64(f)
    key = curve.PointA(kx, ky)
    if not curve.on_curve(key):
        raise ValueError(f"{path}: key does not lie on elliptic curve")
    return WorkHeader(dp, rs, re, key, count, t, version)


def write_work_header(f: BinaryIO, hdr: WorkHeader) -> None:
    _w_u32(f, HEADW)
    _w_u32(f, hdr.version)
    _w_u32(f, hdr.dp)
    _w_int(f, hdr.range_start, 32)
    _w_int(f, hdr.range_end, 32)
    _w_int(f, hdr.key.x, 32)
    _w_int(f, hdr.key.y, 32)
    _w_u64(f, hdr.count)
    _w_f64(f, hdr.time)


def check_compat(h1: WorkHeader, h2: WorkHeader, what: str) -> None:
    """Range/key/version compatibility (reference: Merge.cpp:108-143).

    Version also encodes the -sym marker: symmetric and plain work
    files carry incompatible distance conventions and must not merge.
    """
    if h1.version != h2.version:
        raise ValueError(f"{what}: cannot merge workfiles of different versions")
    if h1.range_start != h2.range_start or h1.range_end != h2.range_end:
        raise ValueError(f"{what}: file range differs")
    if h1.key != h2.key:
        raise ValueError(
            f"{what}: key differs, multiple keys not yet supported"
        )


def _merged_header(h1: WorkHeader, h2: WorkHeader) -> WorkHeader:
    return WorkHeader(
        min(h1.dp, h2.dp), h1.range_start, h1.range_end, h1.key,
        h1.count + h2.count, h1.time + h2.time, h1.version,
    )


@dataclass
class MergeContext:
    """Collision-resolution state derived from a work header."""

    key_to_search: curve.PointA
    key_to_search_neg: curve.PointA
    range_start: int
    dead: int = 0
    result: Optional[SolveResult] = None
    # set for -sym files: collisions need the recentering shift
    width_div2_sym: Optional[int] = None

    @classmethod
    def from_header(cls, hdr: WorkHeader) -> "MergeContext":
        sym = hdr.version == backup.SYM_VERSION
        width_div2 = (hdr.range_end - hdr.range_start) >> 1
        sp = hdr.range_start % N_ORDER
        if sym:
            # symmetric walks recenter the key on the range middle
            # (see KangarooSolver.init_search_key)
            sp = (sp + width_div2) % N_ORDER
        key = hdr.key
        if sp != 0:
            key = curve.add(key, curve.mul(sp).neg())
        return cls(key, key.neg(), hdr.range_start,
                   width_div2_sym=width_div2 if sym else None)

    def on_collision(self, d128_1: int, d128_2: int) -> None:
        d1, t1 = calc_dist_and_type(d128_1)
        d2, t2 = calc_dist_and_type(d128_2)
        dead, res = collision_check(
            d1, t1, d2, t2,
            self.key_to_search, self.key_to_search_neg, self.range_start,
            width_div2_sym=self.width_div2_sym,
        )
        if res is not None:
            self.result = res
        elif dead:
            self.dead += 1


def _merge_regions(file1, file2, dest, ctx, off1=HEADW_HEADER_SIZE,
                   off2=HEADW_HEADER_SIZE, dest_off=HEADW_HEADER_SIZE,
                   n_buckets=HASH_SIZE):
    """Native streamed merge of two bucket regions into dest; returns
    (n_dp, dup).

    Collision pairs found by the native core are resolved afterwards
    (same outcome as resolving mid-stream: the file-1 entry is kept
    either way, matching HashTable::MergeH).
    """
    n_dp, dup, pairs = native.merge_buckets(
        file1, off1, file2, off2, dest, dest_off, n_buckets)
    for d1, d2 in pairs:
        ctx.on_collision(d1, d2)
    return n_dp, dup


def merge_work(
    file1: str, file2: str, dest: str = "", verbose: bool = True
) -> Tuple[bool, Optional[SolveResult], int]:
    """Merge two work files (or dispatch to partition merges).

    Returns (ok, result, dead).  result is the solved key if a tame/wild
    collision is found during the merge; in that case no dest file is
    written (reference: Merge.cpp:222-231).
    """
    if os.path.isdir(file1) and os.path.isdir(file2):
        return merge_work_part_part(file1, file2)
    if os.path.isdir(file1):
        return merge_work_part(file1, file2)
    if not dest:
        raise ValueError("MergeWork: destination argument missing")

    with open(file1, "rb") as f1, open(file2, "rb") as f2:
        h1 = read_work_header(f1, file1)
        h2 = read_work_header(f2, file2)
    check_compat(h1, h2, "MergeWork")
    ctx = MergeContext.from_header(h1)
    tmp = dest + ".tmp"
    with open(tmp, "wb") as fd:
        write_work_header(fd, _merged_header(h1, h2))
    # NB: like the reference, merged files end after the hash table --
    # no trailing kangaroo count (Merge.cpp:194-214).
    n_dp, dup = _merge_regions(file1, file2, tmp, ctx)
    if ctx.result is not None:
        os.remove(tmp)
        return True, ctx.result, ctx.dead + dup
    os.replace(tmp, dest)
    if verbose:
        print(f"MergeWork: Done [{n_dp} DP][dead {ctx.dead + dup}]")
    return True, None, ctx.dead + dup


def merge_dir(
    directory: str, dest: str
) -> Tuple[bool, Optional[SolveResult], int]:
    """Fold-merge every work file in a directory (reference: MergeDir,
    Merge.cpp:255-343): files sorted by size descending, merged two at a
    time into dest."""
    files = []
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            continue
        try:
            with open(path, "rb") as f:
                backup.read_header(f, HEADW)
        except (ValueError, OSError, struct.error):
            continue  # not a work file (struct.error: shorter than a header)
        files.append((os.path.getsize(path), path))
    if not files:
        raise ValueError(f"MergeDir: no work file found in {directory}")
    files.sort(key=lambda t: -t[0])
    total_dead = 0
    acc = files[0][1]
    if len(files) == 1:
        shutil.copyfile(acc, dest)
        return True, None, 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(dest) or ".") as td:
        cur = acc
        for _, path in files[1:]:
            nxt = os.path.join(td, "fold.work")
            _, res, dead = merge_work(cur, path, nxt, verbose=False)
            total_dead += dead
            if res is not None:
                return True, res, total_dead
            cur = nxt
        shutil.copyfile(cur, dest)
    return True, None, total_dead


# ----------------------------------------------------------------------
# Partitioned work directories (reference: PartMerge.cpp)
# ----------------------------------------------------------------------

def part_name(directory: str, i: int, tmp: bool = False) -> str:
    """part file path (reference: GetPartName, PartMerge.cpp:35-46)."""
    suffix = ".tmp" if tmp else ""
    return os.path.join(directory, f"part{i:03d}{suffix}")


def create_empty_part_work(directory: str) -> None:
    """Empty 256-partition work dir (reference: CreateEmptyPartWork)."""
    if os.path.exists(directory):
        raise ValueError(f"CreateEmptyPartWork: {directory} exists")
    os.makedirs(directory)
    open(os.path.join(directory, "header"), "wb").close()
    empty = b"\x00" * 8 * H_PER_PART  # nbItem=0, maxItem=0 per bucket
    for i in range(MERGE_PART):
        with open(part_name(directory, i), "wb") as f:
            f.write(empty)


def _is_empty(path: str) -> bool:
    return not os.path.exists(path) or os.path.getsize(path) == 0


def fill_empty_part_from_file(
    directory: str, work_file: str
) -> Tuple[bool, Optional[SolveResult], int]:
    """Populate an empty partition dir from a plain work file
    (reference: FillEmptyPartFromFile, PartMerge.cpp:428-527)."""
    with open(work_file, "rb") as f1:
        hdr = read_work_header(f1, work_file)
        with open(os.path.join(directory, "header"), "wb") as fh:
            write_work_header(fh, hdr)
        for p in range(MERGE_PART):
            with open(part_name(directory, p), "wb") as fp:
                for _ in range(H_PER_PART):
                    nb = _r_u32(f1)
                    mx = _r_u32(f1)
                    _w_u32(fp, nb)
                    _w_u32(fp, mx)
                    if nb:
                        fp.write(f1.read(32 * nb))
    return True, None, 0


def merge_work_part(
    directory: str, work_file: str
) -> Tuple[bool, Optional[SolveResult], int]:
    """Merge a plain work file into a partition dir (reference:
    MergeWorkPart, PartMerge.cpp:530-750)."""
    header_path = os.path.join(directory, "header")
    if _is_empty(header_path):
        return fill_empty_part_from_file(directory, work_file)

    with open(header_path, "rb") as fh:
        h1 = read_work_header(fh, header_path)
    with open(work_file, "rb") as f2:
        h2 = read_work_header(f2, work_file)
    check_compat(h1, h2, "MergeWorkPart")
    ctx = MergeContext.from_header(h1)
    dup = 0
    off2 = HEADW_HEADER_SIZE
    for p in range(MERGE_PART):
        pname = part_name(directory, p)
        tname = part_name(directory, p, tmp=True)
        cnt2 = native.count_buckets(work_file, off2, H_PER_PART)
        open(tname, "wb").close()
        dup += _merge_regions(pname, work_file, tname, ctx, off1=0,
                              off2=off2, dest_off=0,
                              n_buckets=H_PER_PART)[1]
        off2 += 8 * H_PER_PART + 32 * cnt2
        if ctx.result is not None:
            os.remove(tname)
            return True, ctx.result, ctx.dead + dup
        os.replace(tname, pname)
    with open(header_path, "wb") as fh:
        write_work_header(fh, _merged_header(h1, h2))
    return True, None, ctx.dead + dup


def merge_work_part_part(
    dir1: str, dir2: str, nb_thread: int = 0
) -> Tuple[bool, Optional[SolveResult], int]:
    """Merge partition dir2 into dir1, one worker per partition
    (reference: MergeWorkPartPart, PartMerge.cpp:204-425; <=16 threads).
    """
    h2_path = os.path.join(dir2, "header")
    if _is_empty(h2_path):
        return True, None, 0
    with open(h2_path, "rb") as fh:
        h2 = read_work_header(fh, h2_path)
    h1_path = os.path.join(dir1, "header")
    if _is_empty(h1_path):
        h1 = WorkHeader(h2.dp, h2.range_start, h2.range_end, h2.key, 0, 0.0,
                        h2.version)
    else:
        with open(h1_path, "rb") as fh:
            h1 = read_work_header(fh, h1_path)
        check_compat(h1, h2, "MergeWorkPartPart")
    ctx = MergeContext.from_header(h1)
    if nb_thread <= 0:
        nb_thread = min(16, os.cpu_count() or 1)
    dup_total = [0]
    lock = threading.Lock()

    def merge_one(p: int) -> None:
        if ctx.result is not None:
            return
        tname = part_name(dir1, p, tmp=True)
        open(tname, "wb").close()
        _, dup, pairs = native.merge_buckets(
            part_name(dir1, p), 0, part_name(dir2, p), 0, tname, 0,
            H_PER_PART)
        with lock:
            # collision resolution updates the shared context
            for d1, d2 in pairs:
                ctx.on_collision(d1, d2)
            dup_total[0] += dup
        if ctx.result is None:
            os.replace(tname, part_name(dir1, p))
        else:
            os.remove(tname)

    with ThreadPoolExecutor(max_workers=nb_thread) as ex:
        list(ex.map(merge_one, range(MERGE_PART)))

    if ctx.result is not None:
        return True, ctx.result, ctx.dead + dup_total[0]
    with open(h1_path, "wb") as fh:
        write_work_header(fh, _merged_header(h1, h2))
    return True, None, ctx.dead + dup_total[0]
