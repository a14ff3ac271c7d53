"""herd_s_per_key (s): the mean of `SolveStats.herd_time` over the
window's first pass over the key set, which is never traced."""


def read(ctx):
    keys = ctx["outcome"].program.get("keys")
    if not keys:
        return None
    return sum(k[0] for k in keys) / len(keys)
