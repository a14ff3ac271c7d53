"""Plain PyTorch kangaroo walk: the plain version of the CUDA kernel.

Same semantics and returns as kangaroo_tpu/ops/jump_ref.py, which in
turn match the reference C++ walk (Kangaroo.cpp:379-433):

    jmp   = px.bits64[0] %% NB_JUMP            (low 5 bits of x)
    (px,py) += jumpPoint[jmp]                  (batched affine add)
    dist  += jumpDistance[jmp]                 (128-bit device add)
    DP if top dpSize bits of x are zero        (IsDP, Kangaroo.cpp:148)

Symmetry mode walks equivalence classes {P, -P}: jmp = x mod 16 +
16 * symClass, and after each add the point is normalized to the
smaller y (canonical, <= (p-1)/2); a lane that flips negates its signed
128-bit distance and toggles its class (Kangaroo.cpp:381-399, 422-428).

It serves the CPU path and the tests, and `chip_smoke.py` holds the
kernel against it on the card; the solver never calls it directly (see
`jump_cuda.jump_steps_with_dp`).
"""

from __future__ import annotations

import torch

from ..constants import NB_JUMP
from . import field

# x limb rows captured per DP slot: the table entry is x's low 128
# bits + bucket bits 128..145 (HashTable.cpp:75-100) = limbs 0..9.
DPX_ROWS = 10

#: calls of jump_steps_with_dp in this process
CALLS = 0


def dp_limb_masks(dp_size: int, device="cpu") -> torch.Tensor:
    """(4,) int32 masks of x limbs 12..15 for the top-64-bit DP test.

    dMask has the top dp_size bits of a 64-bit word set
    (reference: Kangaroo.cpp:154-164); x.bits64[3] is limbs 12..15.
    """
    if dp_size <= 0:
        mask64 = 0
    else:
        dp = min(dp_size, 64)
        mask64 = (~((1 << (64 - dp)) - 1)) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor(
        [(mask64 >> (16 * i)) & 0xFFFF for i in range(4)],
        dtype=torch.int32, device=device,
    )


def is_dp(px: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Lane-wise distinguished-point test -> bool (N,)."""
    return ((px[12:16] & masks[:, None]) == 0).all(0)


def select_jump(px, jx, jy, jd, symclass=None):
    """Gather per-lane jump point/distance by x mod NB_JUMP, or in
    symmetry mode by x mod 16 + 16 * symclass (a half-table per class)."""
    if symclass is None:
        jmp = px[0] & (NB_JUMP - 1)
    else:
        jmp = (px[0] & (NB_JUMP // 2 - 1)) + symclass * (NB_JUMP // 2)
    jmp = jmp.long()
    return jx[:, jmp], jy[:, jmp], jd[:, jmp]


def affine_add_walk(px, py, qx, qy):
    """Affine add for the walk: canonical x3, relaxed y3.

    Only x must be canonical (jump selection reads its low bits, the DP
    test its top bits, the hash table stores it); y enters later steps
    only through differences mod p.
    """
    dx = field.submod(qx, px)
    dy = field.submod(qy, py)
    inv = field.batch_inv(dx)
    lam = field.mulmod(dy, inv)
    x3 = field.canonicalize(field.sqrmod(lam, sub=(px, qx)))
    y3 = field.mulmod(lam, field.submod(qx, x3), sub=(qy,))
    return x3, y3


def jump_step(px, py, d, jx, jy, jd, symclass=None):
    """One batched kangaroo jump for every lane.

    With symclass (symmetry mode) the result is normalized into its
    class: y canonical and <= (p-1)/2; a flipped lane negates its
    distance and toggles its class.  Returns (px, py, d[, symclass]).
    """
    qx, qy, qd = select_jump(px, jx, jy, jd, symclass)
    nx, ny = affine_add_walk(px, py, qx, qy)
    nd = field.add_u128(d, qd)
    if symclass is None:
        return nx, ny, nd
    ny = field.canonicalize(ny)
    high = field.y_is_high(ny)
    flip = (high == 1)[None, :]
    ny = torch.where(flip, field.neg_y(ny), ny)
    nd = torch.where(flip, field.neg_u128(nd), nd)
    return nx, ny, nd, symclass ^ high


def record_dps(hit, i, px, d, count, dpx, dpd, step) -> None:
    """Capture step i's DP hits into the free slots and count them (in
    place on count and the slot tensors)."""
    for s in range(dpx.shape[0]):
        sel = hit & (count == s)
        dpx[s] = torch.where(sel[None, :], px[:DPX_ROWS], dpx[s])
        dpd[s] = torch.where(sel[None, :], d, dpd[s])
        step[s] = torch.where(sel, i, step[s])
    count += hit.to(torch.int32)


def jump_steps_with_dp(px, py, d, jx, jy, jd, dp_masks, nb_run: int = 16,
                       slots: int = 2, symmetry: bool = False,
                       symclass=None):
    """nb_run jumps; record up to `slots` DP hits per lane.

    Returns (px, py, d, count, dpx, dpd, step[, symclass]): dpx
    (slots, 10, N) and dpd (slots, 8, N) hold the x / device-distance
    limbs of the first `slots` hits per lane, step (slots, N) the step
    index of each hit within the window, count (N,) all hits (those
    beyond the slots are counted, not stored).  All int32.  Symmetry
    mode takes and returns the (N,) class of each lane (zeros when
    symclass is None); its py is canonical and its captured distances
    are the normalized ones.
    """
    global CALLS
    CALLS += 1
    n = px.shape[1]
    dev = px.device
    dpx = torch.zeros((slots, DPX_ROWS, n), dtype=torch.int32, device=dev)
    dpd = torch.zeros((slots, 8, n), dtype=torch.int32, device=dev)
    step = torch.zeros((slots, n), dtype=torch.int32, device=dev)
    count = torch.zeros((n,), dtype=torch.int32, device=dev)
    if symmetry and symclass is None:
        symclass = torch.zeros((n,), dtype=torch.int32, device=dev)
    for i in range(nb_run):
        if symmetry:
            px, py, d, symclass = jump_step(px, py, d, jx, jy, jd, symclass)
        else:
            px, py, d = jump_step(px, py, d, jx, jy, jd)
        record_dps(is_dp(px, dp_masks), i, px, d, count, dpx, dpd, step)
    if symmetry:
        return px, py, d, count, dpx, dpd, step, symclass
    return px, py, d, count, dpx, dpd, step
