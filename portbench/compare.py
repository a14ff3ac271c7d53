"""The comparison that decides `correct`: what the timed path produced
against the plain reference (`portbench/reference/`), which works it
out again from the benchmark's inputs.

- Herd and walk: sampled lanes of the herd, drawn from the seed, are
  made and walked by the reference from the herd seed as many jumps as
  the program walked them; their x, y (mod p), distance (and the
  program's start, where the search reads it) must be equal.  Lanes the
  program reset (a dead kangaroo redraws from the solver's stream) are
  left out and counted.
- Drain: every distinguished point that a sampled lane passed must be
  in the program's table with the reference's record.
- Table: records sampled from the seed must each hold the x of the
  point their distance and type stand for.

Every number compared is a count of disagreements, and its limit is 0.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .reference import kangaroo as rk
from .reference import secp256k1 as ec

M64 = (1 << 64) - 1


@dataclass
class Check:
    """A number compared and its limit: the check passes when value <=
    limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def limb_int(col: Sequence[int]) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(col))


def read_lanes(state, lanes: Sequence[int]) -> Dict[int, Tuple[int, int, int]]:
    """(x, y mod p, d) of the given lanes of a (px, py, d) herd whose
    arrays are (rows, lanes) tensors or arrays."""
    import torch

    out = {}
    idx = torch.as_tensor(list(lanes), dtype=torch.long)
    cols = []
    for t in state[:3]:
        t = torch.as_tensor(t)
        cols.append(t[:, idx.to(t.device)].cpu().numpy())
    for k, j in enumerate(lanes):
        out[j] = (limb_int(cols[0][:, k]), limb_int(cols[1][:, k]) % ec.P,
                  limb_int(cols[2][:, k]))
    return out


def sample_lanes(rng: np.random.Generator, n_lanes: int, count: int,
                 strata: int = 1) -> List[int]:
    """count lanes drawn without repeat, the same number from each of the
    `strata` equal lane ranges (the shards)."""
    size = n_lanes // strata
    per = max(1, count // strata)
    out = []
    for s in range(strata):
        pick = rng.choice(size, size=min(per, size), replace=False)
        out += [s * size + int(v) for v in pick]
    return sorted(out)


# lane-jumps below which the reference walks in this process: a pool of
# spawned processes costs about a second to start
POOL_MIN_JUMPS = 1 << 20


def pool_size(tasks: int) -> int:
    return max(1, min(tasks, 8, (os.cpu_count() or 2) - 1))


def herd_walks(tasks: List[tuple]) -> list:
    """rk.herd_walk of each task, in a pool of spawned processes when the
    work is large enough to pay for one."""
    jumps = sum(len(t[3]) * sum(t[4]) for t in tasks)
    if jumps < POOL_MIN_JUMPS or len(tasks) <= 1:
        return [rk.herd_walk(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=pool_size(len(tasks)),
                             mp_context=ctx) as pool:
        return list(pool.map(rk.herd_walk, tasks))


def merged(results: list):
    """The starts, ends and distinguished points of several herd_walks."""
    starts, ends, dps = {}, {}, []
    for s, e, d in results:
        starts.update(s)
        ends.update(e)
        dps += d
    return starts, ends, dps


def state_mismatch(ref: Dict[int, Tuple[int, int, int]],
                   prog: Dict[int, Tuple[int, int, int]]) -> int:
    return sum(1 for j, v in ref.items() if prog.get(j) != v)


class Table:
    """The program's table as exported: (h, xlo, xhi, dlo, dhi) columns in
    file order (bucket, then x, ascending)."""

    def __init__(self, cols):
        self.h, self.xlo, self.xhi, self.dlo, self.dhi = (
            np.asarray(c) for c in cols)

    def __len__(self) -> int:
        return len(self.h)

    def find(self, h: int, x128: int) -> Optional[int]:
        """The D128 stored for (bucket, X128), or None."""
        a = int(np.searchsorted(self.h, h, "left"))
        b = int(np.searchsorted(self.h, h, "right"))
        hit = np.nonzero((self.xlo[a:b] == np.uint64(x128 & M64))
                         & (self.xhi[a:b] == np.uint64(x128 >> 64)))[0]
        if not len(hit):
            return None
        i = a + int(hit[0])
        return int(self.dlo[i]) | (int(self.dhi[i]) << 64)

    def record(self, i: int) -> Tuple[int, int, int]:
        return (int(self.h[i]), int(self.xlo[i]) | (int(self.xhi[i]) << 64),
                int(self.dlo[i]) | (int(self.dhi[i]) << 64))


def missing_dps(search: rk.Search, dps: Iterable[Tuple[int, int, int, int]],
                table: Table, skip: Iterable[int] = (),
                before_step: Optional[int] = None) -> Tuple[int, int]:
    """(checked, missing): the reference's distinguished points of lanes
    not in `skip` (and before step `before_step`) that the table lacks or
    holds with another record."""
    skip = set(skip)
    checked = missing = 0
    for lane, step, x, d in dps:
        if lane in skip or (before_step is not None and step >= before_step):
            continue
        h, x128, d128 = rk.record(search, x, d, lane & 1)
        checked += 1
        if table.find(h, x128) != d128:
            missing += 1
    return checked, missing


def bad_records(search: rk.Search, table: Table, rng: np.random.Generator,
                count: int) -> Tuple[int, int]:
    """(checked, bad): sampled table records whose x is not that of the
    point their distance and type stand for."""
    n = len(table)
    if not n:
        return 0, 0
    idx = rng.choice(n, size=min(count, n), replace=False)
    bad = 0
    for i in sorted(int(v) for v in idx):
        h, x128, d128 = table.record(i)
        _, pts = rk.record_points(search, d128)
        if not any(pt is not None and (pt[0] & ((1 << 128) - 1)) == x128
                   and ((pt[0] >> 128) & 0x3FFFF) == h for pt in pts):
            bad += 1
    return len(idx), bad
