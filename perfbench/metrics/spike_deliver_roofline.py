"""``spike_deliver`` (``pack_spikes`` + ``spike_deliver_kernel``, the dense
delivery): its device time against the synapses it delivers, the window's
long-range ones where the fused window kernel delivers the rest, else all."""

from perfbench import work


def read(ctx):
    parts = ("inter",) if work.fused_window(ctx) else ("intra", "inter")
    return work.kernel_share(ctx, ("pack_spikes", "spike_deliver_kernel"), parts)
