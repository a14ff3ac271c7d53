"""Herd creation: tame/wild kangaroo starting states.

Semantics of Kangaroo::CreateHerd (Kangaroo.cpp:670-738):
  * kangaroo j (with parity offset firstType) is TAME if
    (j + firstType) %% 2 == 0 else WILD;
  * tame start distance: uniform in [0, 2^rangePower] (Int::Rand);
  * wild start distance: the same draw minus rangeWidth/2 (mod n);
  * tame position  = d * G,  wild position = keyToSearch + d * G.

Plain walk: distances are carried on the device as 128-bit unsigned
limb vectors; WILD lanes are stored with rangeWidth/2 added so the
value never goes negative (the reference GPU engine's offset,
GPUEngine.cu:381-433): so every lane carries its raw draw.

Symmetry walk (Kangaroo.cpp:686-693, 730-734): draws of rangePower - 1
bits, wild lanes offset by rangeWidth/4 (centred on the translated
key); the device carries the signed two's-complement 128-bit distance,
and each start is normalized into its class {P, -P}: a lane whose y >
(p-1)/2 takes p - y and the negated distance.

For a given MT19937 stream the herd is bit-equal to the JAX package's,
and a herd made in lane shards (create_herd_shards: one draw for the
whole herd, each shard's k*G on its own device) is that herd, split.
The conversions between device and mod-n distances (the JAX herd's
device_distance and true_distance) are vectorized over lanes in
`utils.packing` (device_dist_limbs, true_dist_limbs), where the work
files use them.

The positions (|d| G, negated where d is n - |d|, plus keyToSearch on
wild lanes) are `ops.herd_cuda.positions`: on a card one launch of the
CUDA kernel `kt_herd_kernel`, on the CPU its plain version, `ops.ec`'s
batched curve ops.

create_herd and create_herd_shards record the spans `herd.draws` (the
host's draws) and `herd.kG` (the positions' k*G, one a shard, tagged
with the shard's index: the inputs' copies and the kernel's launch on a
card, which runs on after the span).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import WILD
from ..ops import ec, herd_cuda
from ..utils import rng as rng_mod, spans
from . import curve

_W32 = 0xFFFFFFFF


def draw_start_words(nb: int, range_power: int,
                     rng: Optional[rng_mod.MT19937] = None,
                     symmetry: bool = False) -> np.ndarray:
    """The raw draws r of nb kangaroos, (nb, 4) int64 32-bit words, LSW
    first: one Int::Rand(bits) per lane (Int.cpp:988-1000), the same
    word stream as nb rand_int calls; bits is range_power, or
    range_power - 1 in symmetry mode.

    Plain: a tame lane starts at distance r, a wild lane at
    r - rangeWidth/2 (mod n); on the device both carry r (the wild
    offset convention).  Symmetry: the wild offset is rangeWidth/4.
    """
    if not 0 < range_power <= 128:
        raise ValueError(f"range of {range_power} bits: device distances "
                         f"hold 128 bits")
    bits = range_power - 1 if symmetry else range_power
    gen = rng if rng is not None else rng_mod._global
    nbw = bits // 32
    words = gen.next_block((nbw + 1) * nb).reshape(nb, nbw + 1)
    words = words.astype(np.int64)
    words[:, nbw] &= (1 << (bits % 32)) - 1
    r = np.zeros((nb, 4), dtype=np.int64)
    k = min(nbw + 1, 4)  # at 128 bits the masked extra word is zero
    r[:, :k] = words[:, :k]
    return r


def _sub128(a: np.ndarray, b: np.ndarray):
    """(a - b) mod 2^128 on (n, 4) 32-bit words and the borrow (a < b)."""
    out = np.empty_like(a)
    br = np.zeros(a.shape[0], dtype=np.int64)
    for i in range(4):
        t = a[:, i] - b[:, i] - br
        br = (t < 0).astype(np.int64)
        out[:, i] = t & _W32
    return out, br.astype(bool)


def _limbs(words: np.ndarray, rows: int) -> np.ndarray:
    """(n, 4) 32-bit words -> (rows, n) int32 16-bit limbs."""
    out = np.zeros((rows, words.shape[0]), dtype=np.int32)
    for i in range(4):
        out[2 * i] = words[:, i] & 0xFFFF
        out[2 * i + 1] = words[:, i] >> 16
    return out


def herd_from_draws(
    r: np.ndarray,
    types: np.ndarray,
    width_div2: int,
    key_point: Optional[curve.PointA],
    device="cuda",
    symmetry: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Start state (px, py, d) as int32 tensors on `device` from the
    draws r (draw_start_words, with the same symmetry) and the kangaroo
    types.

    Also rebuilds dead kangaroos in one batch per tick (the reference's
    resets are CreateHerd(1) calls, Kangaroo.cpp:467-471; the caller
    draws in reset order).  Every step is a numpy or tensor operation
    over lanes: no per-lane Python integers.
    """
    n = r.shape[0]
    wild = np.asarray(types) == WILD
    off = width_div2 >> 1 if symmetry else width_div2
    w2 = np.array([(off >> (32 * i)) & _W32 for i in range(4)],
                  dtype=np.int64)[None, :].repeat(n, 0)
    above, below = _sub128(r, w2)        # r - off and its sign
    under, _ = _sub128(w2, r)            # off - r
    # |d| with d the mod-n start distance: r, or |r - off| on wild lanes
    neg = wild & below
    mag = np.where(wild[:, None], np.where(below[:, None], under, above), r)
    ks = _limbs(mag, 16)
    windows = ec.windows_for(ks)
    ks = torch.from_numpy(ks).to(device)
    if key_point is not None and key_point.is_zero:
        # keyToSearch is the identity (the key IS rangeStart*G): wild
        # positions degenerate to d*G, same as tame
        key_point = None
    if not wild.any():
        key_point = None
    # |d| G over the `windows` bytes the range needs (d or n - d,
    # whichever is smaller: n - d lanes are negated), keyToSearch added
    # on wild lanes
    px, py = herd_cuda.positions(ks, torch.from_numpy(neg).to(device),
                                 torch.from_numpy(wild).to(device),
                                 key_point, windows)
    if not symmetry:
        return px, py, torch.from_numpy(_limbs(r, 8)).to(device)
    from ..ops import field

    # signed distance r or r - off, two's complement mod 2^128
    d = np.where(wild[:, None], above, r)
    d = torch.from_numpy(_limbs(d, 8)).to(device)
    flip = (field.y_is_high(py) == 1)[None, :]
    py = torch.where(flip, field.neg_y(py), py)
    d = torch.where(flip, field.neg_u128(d), d)
    return px, py, d


def create_herd(
    nb: int,
    range_power: int,
    width_div2: int,
    key_point: Optional[curve.PointA],
    first_type: int = 0,
    rng: Optional[rng_mod.MT19937] = None,
    device="cuda",
    symmetry: bool = False,
):
    """Start state (px, py, d) for nb kangaroos on `device`; lane j is
    wild when (j + first_type) is odd.

    key_point is the translated search key (keyToSearch); may be None
    when only tame kangaroos are created.  In symmetry mode every lane
    starts normalized, in class 0.
    """
    with spans.span("herd.draws"):
        r = draw_start_words(nb, range_power, rng, symmetry)
    types = (np.arange(nb) + first_type) % 2
    with spans.span("herd.kG"):
        return herd_from_draws(r, types, width_div2, key_point,
                               device=device, symmetry=symmetry)


def create_herd_shards(
    nb: int,
    range_power: int,
    width_div2: int,
    key_point: Optional[curve.PointA],
    shards,
    first_type: int = 0,
    rng: Optional[rng_mod.MT19937] = None,
    symmetry: bool = False,
):
    """create_herd for a herd in lane shards (parallel.sharding.Shard:
    lanes [lo, hi) on a device, with a context for its stream): the
    distances of all nb kangaroos are drawn from the one stream in lane
    order, and each shard's positions are made on its device under its
    stream, lane types by the global lane.  Returns one (px, py, d) per
    shard, bit-equal to create_herd's herd split at the same lanes."""
    with spans.span("herd.draws"):
        r = draw_start_words(nb, range_power, rng, symmetry)
    types = (np.arange(nb) + first_type) % 2
    out = []
    for i, s in enumerate(shards):
        with s.walk(), spans.span("herd.kG", shard=i):
            out.append(herd_from_draws(
                r[s.lo:s.hi], types[s.lo:s.hi], width_div2, key_point,
                device=s.device, symmetry=symmetry))
    return out
