"""What the kangaroo walk needs of an H100, frozen for the benchmark.

A jump is an affine point addition and a 128-bit distance add.  Its
field work, counted in 32-bit integer multiply-add (IMAD) issue slots:
3 multiplies a lane for Montgomery's trick (prefix product and two
unwind steps), a multiply each for lambda and y3, a squaring for
lambda^2, and a share of one safegcd inversion, which the whole herd of
a launch shares (one inversion a step).  A field multiply is 64 wide
products and a squaring 36, plus 8 wide products in the reduction, each
wide product two IMAD slots, and ~4 slots for the folds: (64 + 8) x 2 +
4 = 148 (`MUL_IMAD`) and (36 + 8) x 2 + 4 = 92 (`SQR_IMAD`).  An
inversion is 20 batches of 30 divsteps whose matrices take 78 wide
products and 2 narrow ones: (78 x 2 + 2) x 20 = 3160 (`INV_IMAD`).  At
2^22 lanes this is 832.0 slots a jump, 213.3 ms for a launch of 2^22
lanes x 1024 jumps.

The peak is derived, not measured: an H100 SXM issues 32-bit integer
multiply-adds at half its FP32 FMA rate (64 against 128 a clock per SM
on compute capability 9.0), so half of 67 TFLOP/s over 2 FLOP an FMA,
16.75e12 a second at the full 700 W.
"""

from __future__ import annotations

MUL_IMAD = 148
SQR_IMAD = 92
INV_IMAD = (78 * 2 + 2) * 20
IMAD_PEAK = 67e12 / 2 / 2


def imad_per_jump(lanes: int) -> float:
    """IMAD slots a jump when `lanes` lanes share one inversion a step."""
    muls = 3 * (lanes - 1) + 2 * lanes
    return (muls * MUL_IMAD + lanes * SQR_IMAD + INV_IMAD) / lanes


def bound_s(lanes: int, jumps: float) -> float:
    """Least seconds for `jumps` jumps of launches of `lanes` lanes."""
    return jumps * imad_per_jump(lanes) / IMAD_PEAK
