"""walk_imad_share (%): the walk kernel's share of the IMAD bound over
the traced window: the jumps of its launches (launches x lanes a launch
x steps a launch) times the function's IMAD need a jump
(`portbench/roofline/walk.py`: 832.0 at 2^22 lanes), over the derived
peak, against the launches' device time from the trace."""

from portbench.roofline import walk


def read(ctx):
    trace, prog = ctx["trace"], ctx["outcome"].program
    if trace is None or "lanes_per_launch" not in prog:
        return None
    launches = trace.kernels("kt_jump_kernel")
    busy = sum(o.end_ns - o.start_ns for o in launches) * 1e-9
    if not launches or busy <= 0:
        return None
    lanes = prog["lanes_per_launch"]
    jumps = len(launches) * lanes * prog["nb_run"]
    return 100.0 * walk.bound_s(lanes, jumps) / busy
