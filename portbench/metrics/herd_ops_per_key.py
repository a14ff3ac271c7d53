"""herd_ops_per_key (ops): the device operations of the trace that start
inside a `herd` span, over the number of `herd` spans of the traced
passes."""

from portbench import spans


def read(ctx):
    trace, calls = ctx["trace"], spans.traced_passes(ctx)
    if trace is None or not trace.ops or calls is None:
        return None
    herds = [s for c in calls for s in c.named("herd")]
    if not herds:
        return None
    return spans.ops_inside(trace, herds) / len(herds)
