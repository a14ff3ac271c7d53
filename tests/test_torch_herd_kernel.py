"""The herd kernel's positions (ops/herd_cuda.py, csrc/herd.cuh) on the
CPU: the wrapper's plain version against the exact host curve, and the
kernel's own body, built by g++ (ops/host_kernel.py), against the plain
version at every lane-per-thread count G it launches with, over edge
lanes: |d| = 0, zero bytes in the low, middle and top windows, neg,
wild and tame lanes, keyToSearch at infinity, and lane counts that are
not a multiple of a block.  tests/test_torch_cuda.py holds the kernel
itself to the plain version on a card with the same lanes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from kangaroo_torch.constants import P  # noqa: E402
from kangaroo_torch.core import curve  # noqa: E402
from kangaroo_torch.ops import ec, herd_cuda, host_kernel  # noqa: E402
from kangaroo_torch.utils.intutils import (  # noqa: E402
    ints_to_limbs_fast, limbs_to_ints_fast)

KEY = curve.mul(0xDEADBEEF12345)


def herd_lanes(n: int, windows: int, seed: int, device="cpu"):
    """(mag, neg, wild) for n lanes of |d| below 2^(8 windows): the edge
    lanes first -- |d| = 0 tame and wild, neg and not, 1, a zero low,
    middle and top window, the largest -- then random ones whose bytes
    are zero one time in eight."""
    rs = np.random.RandomState(seed)
    top = (1 << (8 * windows)) - 1
    mid = 8 * (windows // 2)
    edge = [0, 0, 0, 1, top & ~0xFF, top & ~(0xFF << mid),
            top >> 8 if windows > 1 else 1, top, 1 << (8 * (windows - 1))]
    by = np.zeros((32, n), dtype=np.int64)
    by[:windows] = (rs.randint(1, 256, (windows, n))
                    * (rs.random_sample((windows, n)) < 7 / 8))
    mag = (by[0::2] | (by[1::2] << 8)).astype(np.int32)
    k = min(n, len(edge))
    mag[:, :k] = ints_to_limbs_fast(edge[:k]).astype(np.int32)
    neg = rs.random_sample(n) < 0.5
    wild = rs.random_sample(n) < 0.5
    neg[:k] = np.arange(k) % 3 == 1
    wild[:k] = np.arange(k) % 2 == 1
    return tuple(torch.from_numpy(a).to(device) for a in (mag, neg, wild))


def _curve_positions(mag, neg, wild, key):
    """The positions by the exact host curve, lane by lane."""
    out = []
    ks = limbs_to_ints_fast(mag.numpy()).tolist()
    for k, ng, wd in zip(ks, neg.tolist(), wild.tolist()):
        pt = curve.mul(k if k else 1 << 248)
        if k and ng:
            pt = curve.PointA(pt.x, P - pt.y)
        if key is not None and wd:
            pt = curve.add(pt, key)
        out.append((pt.x, pt.y))
    return out


@pytest.mark.parametrize("windows,n,key", [
    (1, 40, KEY), (5, 63, KEY), (11, 37, None), (16, 24, KEY)])
def test_positions_on_cpu_equal_the_curve(windows, n, key):
    """On CPU tensors positions() is the plain version, and that is
    ec.signed_mult_base + ec.add_point, taken on wild lanes: both equal
    the exact host curve lane for lane."""
    mag, neg, wild = herd_lanes(n, windows, seed=windows)
    px, py = herd_cuda.positions(mag, neg, wild, key, windows)
    sx, sy, _ = ec.signed_mult_base(mag, neg, windows)
    if key is not None:
        ax, ay = ec.add_point(sx, sy, torch.zeros(n, dtype=torch.bool), key)
        sx = torch.where(wild[None], ax, sx)
        sy = torch.where(wild[None], ay, sy)
    assert torch.equal(px, sx) and torch.equal(py, sy)
    got = list(zip(limbs_to_ints_fast(px.numpy()).tolist(),
                   limbs_to_ints_fast(py.numpy()).tolist()))
    assert got == _curve_positions(mag, neg, wild, key)


# (windows, lanes, G, key): G as group_for picks it on a card, 1 for a
# batch key's or a reset's lanes up to 64 for a search's herd; lane
# counts below, at and past a block, none of them a multiple of G > 1
BODY_CASES = [
    (1, 1, 1, KEY), (5, 63, 1, KEY), (11, 300, 1, None), (16, 129, 4, KEY),
    (5, 8192 + 37, 64, KEY), (11, 700, 16, KEY), (16, 63, 64, None),
    (32, 150, 2, KEY),
]


@pytest.mark.parametrize("windows,n,group,key", BODY_CASES)
def test_kernel_body_equals_plain(windows, n, group, key):
    """The kernel's body (g++ build of herd.cuh, thread by thread) at G
    lanes a thread equals the plain version bit for bit: canonical x and
    y, on every lane, the ragged tail included."""
    mag, neg, wild = herd_lanes(n, windows, seed=100 + windows)
    got = host_kernel.herd_positions(mag, neg, wild, key, windows, group)
    want = herd_cuda.positions_plain(mag, neg, wild, key, windows)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_kernel_body_refuses_what_the_kernel_does_not_take():
    mag, neg, wild = herd_lanes(8, 2, seed=1)
    for windows, group in ((0, 1), (33, 1), (2, 0), (2, 65)):
        with pytest.raises(ValueError):
            host_kernel.herd_positions(mag, neg, wild, KEY, windows, group)


def test_check_args_rejects_device_dtype_shape_and_layout():
    mag, neg, wild = herd_lanes(8, 2, seed=2)
    assert herd_cuda.check_args(mag, neg, wild, 2) == 8
    meta = torch.zeros(8, dtype=torch.bool, device="meta")
    for args, match in (
            ((mag.long(), neg, wild, 2), "int32"),
            ((mag, neg.int(), wild, 2), "bool"),
            ((mag, neg, meta, 2), "bool on cpu"),
            ((mag[:8].contiguous(), neg, wild, 2), "contiguous"),
            ((mag, neg[:7], wild, 2), "contiguous"),
            ((torch.zeros((16, 16), dtype=torch.int32)[:, ::2], neg, wild,
              2), "contiguous"),
            ((mag, neg, wild, 33), "windows")):
        with pytest.raises(ValueError, match=match):
            herd_cuda.check_args(*args)


def test_table_words_hold_the_generator_table():
    """Entry [w][j] of the kernel's table is x words, then y words, of
    ec._gtable_np's [w, :, :, j] (the 16-bit limbs paired into words)."""
    words = herd_cuda.table_words().view(np.uint32)
    tbl = ec._gtable_np()
    assert words.shape == (32, 256, 16)
    for w, j in ((0, 0), (0, 255), (17, 99), (31, 0), (31, 255)):
        for c in (0, 1):
            limbs = tbl[w, c, :, j].astype(np.uint64)
            want = limbs[0::2] | (limbs[1::2] << 16)
            np.testing.assert_array_equal(words[w, j, 8 * c:8 * c + 8], want)
    assert curve.mul(3 << 8) == curve.PointA(
        int(limbs_to_ints_fast(tbl[1, 0, :, 2:3])[0]),
        int(limbs_to_ints_fast(tbl[1, 1, :, 2:3])[0]))


@pytest.mark.parametrize("n,sms,group", [
    (1 << 22, 132, 64), (1 << 20, 132, 32), (8192, 132, 1), (3, 132, 1),
    (150001, 132, 8), (1 << 17, 132, 4), (1 << 22, 1, 64)])
def test_group_for_spreads_a_herd_over_the_sms(n, sms, group):
    """G is the largest power of two up to 64 that gives every SM a
    block, else 1: a search's 2^22 lanes fill one wave of 512 blocks,
    a batch key's 8192 lanes take 64 SMs."""
    assert herd_cuda.group_for(n, sms) == group
    blocks = -(-n // (herd_cuda.THREADS * group))
    assert blocks >= sms or group == 1


def test_max_group_is_the_bodys():
    """MAX_GROUP, which group_for never exceeds, is the most lanes a
    thread that herd.cuh's herd_args takes: the body runs at it, equal
    to the plain version, and refuses one more."""
    mag, neg, wild = herd_lanes(herd_cuda.THREADS + 5, 2, 11)
    got = host_kernel.herd_positions(mag, neg, wild, KEY, 2,
                                     herd_cuda.MAX_GROUP)
    want = herd_cuda.positions_plain(mag, neg, wild, KEY, 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        host_kernel.herd_positions(mag, neg, wild, KEY, 2,
                                   herd_cuda.MAX_GROUP + 1)


def test_adds_needed_and_bound():
    """A lane's first nonzero byte takes the table point (no add); each
    later nonzero byte is an add, and so is the key step on a wild
    lane.  The bound is those adds at the walk's IMAD a jump."""
    ks = [0, 1, 0x0100, 0x0101, 0xFF00FF]
    mag = ints_to_limbs_fast(ks)
    wild = np.array([True, False, True, False, True])
    assert herd_cuda.adds_needed(mag, wild, 3) == 0 + 0 + 0 + 1 + 1 + 3
    from kangaroo_torch.ops import jump_cuda

    assert herd_cuda.bound_ms(1 << 22, 12 << 22) == pytest.approx(
        (12 << 22) * jump_cuda.imad_per_jump(1 << 22)
        / jump_cuda.IMAD_PEAK * 1e3)
