"""pull_lag_ms (ms): how long shard 0's card sits with nothing queued
while the host pulls the other shards: per drained tick of the traced
window's `solve()` call, from the end of the `compact` span tagged shard
0 to the start of that tick's `launch` span, mean over those ticks.
None where the spans carry no `shard` field (a program from before it)."""

from portbench import spans


def read(ctx):
    call = spans.window(ctx)
    if call is None or not hasattr(call.spans[0], "shard"):
        return None
    first = {s.parent: s.end for s in call.named("compact") if s.shard == 0}
    lags = [s.start - first[s.parent] for s in call.named("launch")
            if s.parent in first]
    if not lags:
        return None
    return 1e-6 * sum(lags) / len(lags)
