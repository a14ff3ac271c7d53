"""herd_draw_s_per_key (s): the mean of the herd's host draws (the
`herd.draws` span) a key, over the window's first pass over the key
set, which is never traced."""

from portbench import spans


def read(ctx):
    calls = spans.first_pass(ctx)
    if calls is None:
        return None
    return sum(c.seconds("herd.draws") for c in calls) / len(calls)
