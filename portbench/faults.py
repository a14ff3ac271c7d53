"""Faults planted under the timed path, for the control and the tests of
the comparison (`python -m portbench.run ... --fault <name>`; the
benchmark's own runs plant none).  Each wraps a function of the program
that the solver looks up at call time.

- drop_dps (the control): every other distinguished point of a tick is
  dropped before the drain, which breaks the guarantee that every DP is
  kept.
- stale_step: the walk returns its input state unchanged.
- half_lanes: the walk leaves the second half of each shard's lanes
  where they were, and finds no DP on them.
- drop_shard: the DPs of every shard but the first never reach the host
  table (the exchange between the cards left out).  No cell of the
  benchmark has more than one card yet; this serves the CPU test's
  four-shard cell, and the four-card cell when it comes.
- alter_dp: each DP's distance is altered where it is produced.
- alter_key: a solved key is reported one higher.
"""

from __future__ import annotations

FAULTS = ("drop_dps", "stale_step", "half_lanes", "drop_shard", "alter_dp",
          "alter_key")


def _wrap_compact(edit):
    from kangaroo_torch.parallel import sharding

    inner = sharding.compact

    def compact(shard, wins, slots, nb_run):
        lost, blk = inner(shard, wins, slots, nb_run)
        return lost, edit(shard, blk)

    sharding.compact = compact


def _wrap_walk(edit):
    from kangaroo_torch.ops import jump_cuda

    inner = jump_cuda.jump_steps_with_dp

    def walk(px, py, d, *args, **kwargs):
        before = [t.clone() for t in (px, py, d)]
        sym = kwargs.get("symmetry", False)
        cls = kwargs.get("symclass")
        cls_before = cls.clone() if sym and cls is not None else None
        out = list(inner(px, py, d, *args, **kwargs))
        edit(out, before, cls_before)
        return tuple(out)

    jump_cuda.jump_steps_with_dp = walk


def _stale(out, before, cls_before):
    for k in range(3):
        out[k].copy_(before[k])
    if len(out) > 7 and cls_before is not None:
        out[7].copy_(cls_before)


def _half(out, before, cls_before):
    n = before[0].shape[1]
    for k in range(3):
        out[k][:, n // 2:] = before[k][:, n // 2:]
    if len(out) > 7 and cls_before is not None:
        out[7][n // 2:] = cls_before[n // 2:]
    out[3][n // 2:] = 0


def _alter_dp(shard, blk):
    blk = blk.copy()
    blk[:, 10] ^= 1
    return blk


def _alter_key():
    from kangaroo_torch.core import solver as solver_mod

    inner = solver_mod.collision_check

    def check(*args, **kwargs):
        dead, res = inner(*args, **kwargs)
        if res is not None:
            res.private_key += 1
        return dead, res

    solver_mod.collision_check = check


def apply(name: str) -> None:
    if not name:
        return
    if name == "drop_dps":
        _wrap_compact(lambda shard, blk: blk[::2])
    elif name == "stale_step":
        _wrap_walk(_stale)
    elif name == "half_lanes":
        _wrap_walk(_half)
    elif name == "drop_shard":
        _wrap_compact(lambda shard, blk: blk if shard.lo == 0 else blk[:0])
    elif name == "alter_dp":
        _wrap_compact(_alter_dp)
    elif name == "alter_key":
        _alter_key()
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
