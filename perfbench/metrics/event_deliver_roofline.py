"""``event_deliver_kernel`` (the event scatter): its device time against the
synapses it delivers, the window's long-range ones where the fused window
kernel delivers the rest, else all."""

from perfbench import work


def read(ctx):
    parts = ("inter",) if work.fused_window(ctx) else ("intra", "inter")
    return work.kernel_share(ctx, ("event_deliver_kernel",), parts)
