"""The share of the traced stretch's wall time in which no operation ran on
the device (the profiler's CUPTI trace; the union of kernels, copies and
sets)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
