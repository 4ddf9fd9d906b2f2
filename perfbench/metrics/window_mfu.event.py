"""``window_mfu``, read alike, in the cells on the ``event`` route: their
windows are paced by the host as much as by the card, so their runs spread
more than the dense route's, and the metric has a bound or a moved metric
of its own there (PERF.md)."""

from perfbench.harness import load_metric


def read(ctx):
    return load_metric("window_mfu").read(ctx)
