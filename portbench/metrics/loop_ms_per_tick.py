"""loop_ms_per_tick (ms): the solver loop's seconds (`SolveStats.time`:
launch, compaction, drain, resets) over its ticks, summed over the
window's first pass over the key set, which is never traced."""


def read(ctx):
    keys = ctx["outcome"].program.get("keys")
    ticks = sum(k[2] for k in keys) if keys else 0
    if not ticks:
        return None
    return 1e3 * sum(k[1] for k in keys) / ticks
