"""drain_ms_per_tick.batch (ms): the `drain` spans' self time (encode,
insert, collision checks; the dead-lane `reset` inside left out) over
the ticks, summed over the window's first pass over the key set, which
is never traced."""

from portbench import spans


def read(ctx):
    calls = spans.first_pass(ctx)
    ticks = sum(c.ticks for c in calls) if calls else 0
    if not ticks:
        return None
    return 1e3 * sum(c.self_seconds("drain") for c in calls) / ticks
