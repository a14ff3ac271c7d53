"""compact_ms_max (ms): a drained tick's slowest shard in `compact` (its
compaction and copy to the host, after the wait for its windows, which
is `compact.wait`), mean over the drained ticks of the traced window's
`solve()` call."""

from collections import defaultdict

from portbench import spans


def read(ctx):
    call = spans.window(ctx)
    if call is None:
        return None
    by_tick = defaultdict(float)
    for s in call.named("compact"):
        by_tick[s.parent] = max(by_tick[s.parent], s.seconds)
    if not by_tick:
        return None
    return 1e3 * sum(by_tick.values()) / len(by_tick)
