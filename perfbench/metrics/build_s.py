"""Seconds to build the network and the engine (``build_network`` and
``make_simulation``, ending in a synchronize)."""


def read(ctx):
    return ctx.build_s
