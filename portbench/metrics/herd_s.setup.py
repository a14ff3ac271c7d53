"""herd_s.setup (s): `SolveStats.herd_time` of the set-up's herd
creation (`solve(max_ticks=0)`), the herd's draws and its k*G."""


def read(ctx):
    return ctx["outcome"].program.get("herd_s_setup")
