"""Seconds from the process's start to the first timed window: CUDA, the
kernels' load (their build on a checkout's first run), the network's
build, the engine and the warm-up windows."""


def read(ctx):
    return ctx.setup_s
