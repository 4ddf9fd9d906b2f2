"""Kernel launches (every kernel the trace holds, PyTorch's included) a
traced window."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.n_traced == 0:
        return None
    return t["launches"] / ctx.n_traced
