"""Time the pieces of the main path on one CUDA card.

    python -m kangaroo_torch.profile_walk

Prints one line per measurement, at the main path's shape (2^22 lanes,
1024 steps per launch, DP 14, 6 slots):
  * herd creation (`create_herd` in a `herd` span, through its
    synchronise), split by its spans: `herd.draws` (the host's MT19937
    draws), `herd.kG` (scalar and distance limbs, and the batched k*G
    and wild key add launched on the card) and the rest, the card
    finishing them;
  * the walk kernel: its geometry and occupancy (threads x G lanes
    per block, registers, resident blocks per SM, warps per scheduler),
    ms per launch (CUDA events, after a warm-up), G jumps/s, the
    function's IMAD bound and this design's traffic floor.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from .core import curve, herd
from .core.jumptable import create_jump_table
from .ops import jump_cuda, jump_ref
from .utils import spans
from .utils.rng import MT19937

RANGE_POWER = 64
LANES = 1 << 22
STEPS = 1024
DP_SIZE = 14
SLOTS = 6


def cuda_ms(fn, reps: int = 1):
    """Run fn() reps times on the current stream; returns (its last
    result, ms per call by CUDA events)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b) / reps


def profile_herd(n, dev):
    """Herd creation split by its spans; returns the herd."""
    wd2 = ((1 << RANGE_POWER) - 1) >> 1
    key = curve.mul(0xDEADBEEF12345)
    with spans.span("herd") as whole:
        px, py, d = herd.create_herd(n, RANGE_POWER, wd2, key, 0,
                                     MT19937(0x5EED), device=dev)
        torch.cuda.synchronize()
    inner = {s.name: s.seconds for s in spans.recorded()
             if s.parent == whole.id}
    tail = whole.seconds - sum(inner.values())
    print(f"herd {n} lanes: {whole.seconds:.2f} s: draws "
          f"{inner['herd.draws']:.2f} s, limbs + k*G launched "
          f"{inner['herd.kG']:.2f} s, the card finishing {tail:.2f} s",
          flush=True)
    return px, py, d


def profile_kernel(state, dev):
    jx, jy, jd = (torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in create_jump_table(RANGE_POWER).as_arrays())
    masks = jump_ref.dp_limb_masks(DP_SIZE, dev)
    n = state[0].shape[1]

    def run():
        return jump_cuda.jump_steps_with_dp(*state, jx, jy, jd, masks,
                                            nb_run=STEPS, slots=SLOTS)

    occ = jump_cuda.occupancy(n)
    print(f"walk kernel: {jump_cuda.THREADS} threads x {jump_cuda.GROUP} "
          f"lanes per block, {occ['regs']} registers, {occ['local_bytes']} "
          f"B local, {occ['blocks_per_sm']} blocks/SM, "
          f"{occ['warps_per_scheduler']:.2f} warps per scheduler at {n} "
          f"lanes", flush=True)
    run()  # warm-up
    _, ms = cuda_ms(run, reps=2)
    bound, by = jump_cuda.bound_ms(n, STEPS, SLOTS)
    print(f"walk: {ms:.1f} ms/launch of {n} lanes x {STEPS} steps, "
          f"{n * STEPS / ms / 1e6:.3f} G jumps/s; bound {bound:.1f} ms "
          f"({by}, {jump_cuda.imad_per_jump(n):.1f} IMAD/jump); this "
          f"design's {jump_cuda.imad_per_jump():.1f} IMAD/jump at G "
          f"{jump_cuda.GROUP} and traffic floor "
          f"{jump_cuda.design_traffic_ms(n, STEPS):.1f} ms",
          flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_walk: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(f"{torch.cuda.get_device_name(0)} ({smi.strip()})", flush=True)
    profile_kernel(profile_herd(LANES, dev), dev)


if __name__ == "__main__":
    main()
