"""drain_us_per_dp (us): the traced window's `drain` self time (encode,
insert, collision checks; the dead-lane `reset` inside left out, as in
drain_ms_per_tick.search) over the records that call's drains handed to
the table (the program's counter `dps`).  None where the program keeps
no counters (a program from before them)."""

from portbench import spans


def read(ctx):
    call = spans.window(ctx)
    if call is None:
        return None
    try:
        from kangaroo_torch.utils.spans import counters
    except ImportError:
        return None
    dps = counters(call.spans[0].serial).get("dps")
    if not dps:
        return None
    return 1e6 * call.self_seconds("drain") / dps
