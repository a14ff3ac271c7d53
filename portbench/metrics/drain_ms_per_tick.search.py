"""drain_ms_per_tick.search (ms): the `drain` spans' self time (encode,
insert, collision checks; the dead-lane `reset` inside left out) over
the ticks of the traced window's `solve()` call."""

from portbench import spans


def read(ctx):
    call = spans.window(ctx)
    if call is None or not call.ticks:
        return None
    return 1e3 * call.self_seconds("drain") / call.ticks
