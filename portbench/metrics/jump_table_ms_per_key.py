"""jump_table_ms_per_key (ms): the mean `jump_table` span (the jump
table made anew and copied to the card) a `solve()` call, over the
window's first pass over the key set, which is never traced."""

from portbench import spans


def read(ctx):
    calls = spans.first_pass(ctx)
    if calls is None:
        return None
    return 1e3 * sum(c.seconds("jump_table") for c in calls) / len(calls)
