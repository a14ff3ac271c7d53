"""Operands that run every carry of field.cuh's multiply, squaring and
512-bit reduction, for the host build (tests/test_torch_field_cuh.py)
and the card (tests/test_torch_cuda.py).

A carry runs furthest where words are all ones or all zeros, so the
sets are: every operand whose 8 words are each 0 or 2^32 - 1 (2^8 of
them); the band [p, 2^256) of relaxed values the ops take and give
(2^32 + 977 of them: both ends and BAND_SAMPLE drawn from it); the
values around p; for the reduction, every 512-bit input whose 16 words
are each 0 or 2^32 - 1.  Those alone never carry where a row of wide
products joins its halves (with b's words 0 or 2^32 - 1, the low half
of a * b_j and the high half of a * b_{j-1} add up to at most 2^32 -
1), so each op also takes 2^16 operands whose words are drawn from
MIXED_WORDS, where a row carries wherever b_{j-1} > b_j.  A result is
right when it is below 2^256 and congruent to the exact value mod p.
"""

from itertools import product

import numpy as np

P = (1 << 256) - (1 << 32) - 977
M32 = 0xFFFFFFFF
BAND = (1 << 256) - P  # the relaxed values p .. 2^256 - 1
BAND_SAMPLE = 1 << 12
EDGES = (P - 1, P, P + 1, 1 << 255, (1 << 256) - 1)
MIXED_WORDS = (0, 1, 1 << 31, M32 - 1, M32)
MIXED = 1 << 16
MUL_CASES = ("words", "band", "edges", "mixed")
REDUCE_CASES = ("ones_zeros", "mixed")


def to_words(vals, nw: int = 8) -> np.ndarray:
    """(len(vals), nw) uint32 words, least significant first."""
    raw = b"".join(v.to_bytes(4 * nw, "little") for v in vals)
    return np.frombuffer(raw, dtype="<u4").reshape(len(vals), nw).copy()


def to_ints(words: np.ndarray) -> list:
    w = np.ascontiguousarray(words, dtype="<u4")
    return [int.from_bytes(row.tobytes(), "little") for row in w]


def to_limbs(words: np.ndarray) -> np.ndarray:
    """(nw, n) words -> (2 nw, n) int32 16-bit limbs (the P1 layout)."""
    out = np.empty((2 * words.shape[0], words.shape[1]), np.int32)
    out[0::2] = words & 0xFFFF
    out[1::2] = words >> 16
    return out


def from_limbs(limbs: np.ndarray) -> np.ndarray:
    """(2 nw, n) 16-bit limbs -> (n, nw) uint32 words."""
    w = limbs[0::2].astype(np.uint32) | (limbs[1::2].astype(np.uint32) << 16)
    return np.ascontiguousarray(w.T)


def ones_zeros(nw: int) -> list:
    """Every value of nw words each 0 or 2^32 - 1 (2^nw values)."""
    return [sum(M32 << (32 * i) for i in range(nw) if m >> i & 1)
            for m in range(1 << nw)]


def band() -> list:
    """Both ends of [p, 2^256) and BAND_SAMPLE values drawn from it."""
    rs = np.random.RandomState(0xBA2D)
    inner = rs.randint(1, BAND - 1, BAND_SAMPLE, dtype=np.int64)
    return [P, (1 << 256) - 1] + [P + int(k) for k in inner]


def mixed(nw: int, count: int, seed: int) -> list:
    """count values of nw words each drawn from MIXED_WORDS."""
    pick = np.random.RandomState(seed).randint(0, len(MIXED_WORDS),
                                               (count, nw))
    return [sum(MIXED_WORDS[j] << (32 * i) for i, j in enumerate(row))
            for row in pick.tolist()]


def mul_pairs(case: str):
    """(a, b) operand lists of a multiply case: every pair of
    ones_zeros(8); the band against ones_zeros(8); EDGES against all;
    MIXED pairs of mixed words."""
    oz = ones_zeros(8)
    if case == "mixed":
        return mixed(8, MIXED, 0xA), mixed(8, MIXED, 0xB)
    if case == "words":
        pairs = product(oz, oz)
    elif case == "band":
        pairs = product(band(), oz)
    elif case == "edges":
        pairs = product(EDGES, oz + band() + list(EDGES))
    else:
        raise ValueError(case)
    a, b = zip(*pairs)
    return list(a), list(b)


def sqr_values(case: str) -> list:
    if case == "mixed":
        return mixed(8, MIXED, 0xC)
    return {"words": ones_zeros(8), "band": band(),
            "edges": list(EDGES)}[case]


def reduce_inputs(case: str) -> list:
    """512-bit inputs of fe_reduce512: every value of 16 words each 0 or
    2^32 - 1, or MIXED values of mixed words."""
    if case == "ones_zeros":
        return ones_zeros(16)
    if case != "mixed":
        raise ValueError(case)
    return mixed(16, MIXED, 0x512)


def wrong(got: list, want: list) -> int:
    """How many results are not below 2^256 and congruent to want."""
    return sum(1 for g, w in zip(got, want)
               if g >> 256 or (g - w) % P)
