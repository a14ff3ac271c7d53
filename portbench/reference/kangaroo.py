"""The plain kangaroo walk of Pollard's method, as the reference solver
(JeanLucPons/Kangaroo) defines it, in Python integers.

Everything here is worked out from the benchmark's inputs alone: the
range, the public key, the herd seed and the solver's options.

- Random words: MT19937 seeded with init_genrand (Knuth's initializer),
  drawn through numpy's own MT19937, the generator the reference uses
  (SECPK1/Random.cpp).  An n-bit draw (Int::Rand) takes n // 32 full
  words, least significant first, and one more word masked to n % 32
  bits.
- Jump table (Kangaroo.cpp CreateJumpTable): 32 distances drawn from
  the fixed seed 0x600DCAFE, of rangePower / 2 + 1 bits (symmetry:
  rangePower / 2 bits, the two halves scaled by consecutive odd primes
  above 2^(jumpBit / 2)), redrawn until their mean, summed word by
  word in doubles, lies in (2^(jumpBit - 1.05), 2^(jumpBit - 0.95)).
- Herd (CreateHerd): lane j is tame when j is even; its draw r has
  rangePower bits (symmetry: rangePower - 1).  A tame lane stands at
  r * G, a wild one at K' + (r - W / 2) * G (symmetry: K' + (r - W / 4)
  * G), K' the key translated by the range start (symmetry: by the
  start plus W / 2), W the range's width.  Distances are kept as the
  card keeps them, modulo 2^128: r on every plain lane, the signed
  r or r - W / 4 in symmetry mode.
- A jump adds the jump point with index x mod 32 (symmetry: x mod 16 +
  16 * class) and its distance.  In symmetry mode a point whose y lies
  above (p - 1) / 2 is replaced by its negation, its distance negated
  and its class toggled; the herd starts so normalized, in class 0.
- A point is distinguished when the top dp bits of x are zero; the
  table keeps its x's bits 0..127, its bucket (x's bits 128..145) and
  the distance encoded as HashTable::Convert does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from . import secp256k1 as ec

NB_JUMP = 32
JUMP_SEED = 0x600DCAFE
M128 = (1 << 128) - 1
M126 = (1 << 126) - 1


class Words:
    """The 32-bit MT19937 stream of a seed (init_genrand), in blocks."""

    def __init__(self, seed: int):
        legacy = np.random.RandomState(seed & 0xFFFFFFFF).get_state()
        self._bg = np.random.MT19937()
        self._bg.state = {"bit_generator": "MT19937",
                          "state": {"key": legacy[1], "pos": legacy[2]}}

    def take(self, count: int) -> np.ndarray:
        return self._bg.random_raw(count).astype(np.uint64)

    def rand(self, bits: int) -> int:
        w = self.take(bits // 32 + 1)
        v = 0
        for i in range(bits // 32):
            v |= int(w[i]) << (32 * i)
        top = int(w[-1]) & ((1 << (bits % 32)) - 1)
        return v | top << (32 * (bits // 32))


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    small = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    for q in small:
        if n % q == 0:
            return n == q
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in small:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _odd_prime_from(v: int) -> int:
    while not _is_prime(v):
        v += 2
    return v


def _words_as_double(v: int) -> float:
    s, scale = 0.0, 1.0
    for _ in range(10):
        s += float(v & 0xFFFFFFFF) * scale
        scale *= 4294967296.0
        v >>= 32
    return s


@dataclass
class JumpTable:
    dist: List[int]
    pts: List[Tuple[int, int]]


def jump_table(range_power: int, symmetry: bool) -> JumpTable:
    bit = min(128, range_power // 2 if symmetry else range_power // 2 + 1)
    lo, hi = 2.0 ** (bit - 1.05), 2.0 ** (bit - 0.95)
    if symmetry:
        u = _odd_prime_from((1 << (bit // 2)) + 1)
        v = _odd_prime_from(u + 2)
    words = Words(JUMP_SEED)
    dist: List[int] = []
    for _ in range(100):
        dist = []
        for i in range(NB_JUMP):
            if symmetry:
                d = words.rand(bit // 2) * (u if i < NB_JUMP // 2 else v)
            else:
                d = words.rand(bit)
            dist.append(d or 1)
        if lo < _words_as_double(sum(dist)) / NB_JUMP < hi:
            break
    return JumpTable(dist, [ec.mul_g(d) for d in dist])


@dataclass
class Search:
    """One key's search as the solver sets it up."""
    range_start: int
    range_end: int
    key: Tuple[int, int]
    symmetry: bool

    @property
    def width(self) -> int:
        return self.range_end - self.range_start

    @property
    def power(self) -> int:
        return self.width.bit_length()

    @property
    def half(self) -> int:
        return self.width >> 1

    def translated_key(self) -> Tuple[int, int]:
        shift = self.range_start + (self.half if self.symmetry else 0)
        return ec.add(self.key, ec.neg(ec.mul_g(shift)))


@dataclass
class Lane:
    """A lane as the card holds it: x, y, the distance mod 2^128, the
    symmetry class; `lane` its index in the herd (even: tame)."""
    lane: int
    x: int
    y: int
    d: int
    cls: int = 0

    @property
    def wild(self) -> int:
        return self.lane & 1


def _normalize(lane: Lane) -> None:
    if lane.y > ec.HALF_P:
        lane.y = ec.P - lane.y
        lane.d = (-lane.d) & M128
        lane.cls ^= 1


def _signed128(v: int) -> int:
    return v - (1 << 128) if v >> 127 else v


def herd_draws(seed: int, n_lanes: int, lanes: Sequence[int], bits: int,
               block: int = 1 << 20) -> Dict[int, int]:
    """The draws r of the given lanes of an n_lanes herd drawn in lane
    order from the seed's stream."""
    per = bits // 32 + 1
    want = sorted(set(lanes))
    words = Words(seed)
    out: Dict[int, int] = {}
    k = 0
    for lo in range(0, n_lanes, block):
        hi = min(n_lanes, lo + block)
        w = words.take((hi - lo) * per).reshape(hi - lo, per)
        while k < len(want) and want[k] < hi:
            row = w[want[k] - lo]
            v = 0
            for i in range(per - 1):
                v |= int(row[i]) << (32 * i)
            v |= (int(row[-1]) & ((1 << (bits % 32)) - 1)) << (32 * (per - 1))
            out[want[k]] = v
            k += 1
        if k == len(want):
            break
    return out


def herd(search: Search, seed: int, n_lanes: int,
         lanes: Sequence[int]) -> List[Lane]:
    """The start of the given lanes of an n_lanes herd."""
    sym = search.symmetry
    bits = search.power - 1 if sym else search.power
    draws = herd_draws(seed, n_lanes, lanes, bits)
    key = search.translated_key()
    off = search.half >> 1 if sym else search.half
    out = []
    for j in lanes:
        r = draws[j]
        if j & 1:
            true = r - off
            pt = ec.add(key, ec.mul_g(true))
            d = (true if sym else r) & M128
        else:
            pt = ec.mul_g(r)
            d = r
        lane = Lane(j, pt[0], pt[1], d)
        if sym:
            _normalize(lane)
            lane.cls = 0
        out.append(lane)
    return out


def walk(lanes: List[Lane], steps: int, table: JumpTable, dp: int,
         symmetry: bool, first_step: int = 0
         ) -> List[Tuple[int, int, int, int]]:
    """Walk the lanes `steps` jumps in place (one inversion a step for
    all of them, Montgomery's trick); returns each distinguished point
    passed as (lane, step, x, d), step counted from first_step."""
    half = NB_JUMP // 2
    shift = 256 - dp
    P = ec.P
    dps = []
    n = len(lanes)
    xs = [ln.x for ln in lanes]
    ys = [ln.y for ln in lanes]
    ds = [ln.d for ln in lanes]
    cs = [ln.cls for ln in lanes]
    jd, jp = table.dist, table.pts
    pre = [0] * n
    for s in range(steps):
        idx = [(x & (half - 1)) + half * c if symmetry else x & (NB_JUMP - 1)
               for x, c in zip(xs, cs)]
        acc = 1
        dxs = []
        for i in range(n):
            dx = jp[idx[i]][0] - xs[i]
            dxs.append(dx)
            acc = acc * dx % P
            pre[i] = acc
        inv = pow(acc, -1, P)
        for i in range(n - 1, -1, -1):
            di = inv * pre[i - 1] % P if i else inv
            inv = inv * dxs[i] % P
            qx, qy = jp[idx[i]]
            lam = (qy - ys[i]) * di % P
            x3 = (lam * lam - xs[i] - qx) % P
            y3 = (lam * (xs[i] - x3) - ys[i]) % P
            d = (ds[i] + jd[idx[i]]) & M128
            if symmetry and y3 > ec.HALF_P:
                y3 = P - y3
                d = (-d) & M128
                cs[i] ^= 1
            xs[i], ys[i], ds[i] = x3, y3, d
            if not x3 >> shift:
                dps.append((lanes[i].lane, first_step + s, x3, d))
    for ln, x, y, d, c in zip(lanes, xs, ys, ds, cs):
        ln.x, ln.y, ln.d, ln.cls = x, y, d, c
    return dps


def true_distance(search: Search, d: int, wild: int) -> int:
    """The distance mod N that a lane's device distance stands for."""
    if search.symmetry:
        return _signed128(d) % ec.N
    return (d - search.half) % ec.N if wild else d % ec.N


def record(search: Search, x: int, d: int, wild: int) -> Tuple[int, int, int]:
    """(bucket, X128, D128) of a distinguished point as the table keeps
    it (HashTable::Convert)."""
    t = true_distance(search, d, wild)
    sign = t >> 255
    mag = (ec.N - t) & M128 if sign else t & M128
    return ((x >> 128) & 0x3FFFF, x & M128,
            (mag & M126) | (sign << 127) | (wild << 126))


def record_points(search: Search,
                  d128: int) -> Tuple[int, List[Tuple[int, int]]]:
    """The kangaroo type of a table record and the points whose x it may
    hold: d * G for a tame kangaroo, K' + d * G for a wild one
    (symmetry: also -K' + d * G, since a class walk may have negated
    it), d the record's distance."""
    wild = (d128 >> 126) & 1
    mag = d128 & M126
    d = (ec.N - mag) % ec.N if d128 >> 127 else mag
    base = ec.mul_g(d)
    if not wild:
        return wild, [base]
    key = search.translated_key()
    pts = [ec.add(key, base)]
    if search.symmetry:
        pts.append(ec.add(ec.neg(key), base))
    return wild, pts


def herd_walk(args) -> Tuple[Dict[int, Tuple[int, int, int]],
                             Dict[int, Tuple[int, int, int]],
                             List[Tuple[int, int, int, int]]]:
    """herd() then walk() for a process pool: args (search, herd seed,
    herd lanes, lanes, segments, jump table, dp), `segments` the jumps of
    each solve() call that walked the herd: a call restores the herd in
    class 0, as the reference's restore does.  Returns the lanes' start
    and end as {lane: (x, y, d)} and the distinguished points passed."""
    search, seed, n_lanes, lanes, segments, table, dp = args
    herd_lanes = herd(search, seed, n_lanes, lanes)
    starts = {ln.lane: (ln.x, ln.y, ln.d) for ln in herd_lanes}
    dps: List[Tuple[int, int, int, int]] = []
    done = 0
    for steps in segments:
        for ln in herd_lanes:
            ln.cls = 0
        dps += walk(herd_lanes, steps, table, dp, search.symmetry, done)
        done += steps
    return starts, {ln.lane: (ln.x, ln.y, ln.d) for ln in herd_lanes}, dps


def chunks(items: Sequence, parts: int) -> Iterable[Sequence]:
    parts = max(1, min(parts, len(items)))
    for i in range(parts):
        yield items[i::parts]
