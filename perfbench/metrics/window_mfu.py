"""The whole window's share of the chip's peak: the least time the untraced
timed windows' needed work could take (:mod:`perfbench.work`: every
neuron's state and ring slot each cycle, every delivered synapse's target,
weight, delay and ring add, whichever route runs; bytes bind it) over
those windows' time on the device's clock, in %."""

from perfbench import work


def read(ctx):
    if ctx.peaks is None or ctx.untraced_wall_s <= 0:
        return None
    least = work.least_seconds(ctx.work_untraced, work.PARTS, ctx.peaks)
    return 100.0 * least / ctx.untraced_wall_s
