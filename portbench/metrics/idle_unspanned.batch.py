"""idle_unspanned.batch (s): the card's idle seconds, from the first to
the last device operation of the trace, in which no span is open other
than `solve` and `tick` (the spans that hold the whole loop), over the
`solve()` calls of the traced passes: the idle time a key that the
spans leave unexplained."""

from portbench import spans

# the spans that hold the whole loop: idle time under them alone is idle
# time the spans do not explain
LOOP = ("solve", "tick")


def read(ctx):
    calls = spans.traced_passes(ctx)
    split = spans.idle_by_span(ctx["trace"])
    if not calls or not split:
        return None
    return sum(split.get(k, 0.0) for k in LOOP + ("none",)) / len(calls)
