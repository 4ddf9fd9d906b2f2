"""``iaf_spikes`` + ``iaf_deposit`` (the fused ignore-and-fire window): their
device time against what they do, every neuron's steps and the window's
short-range deliveries."""

from perfbench import work


def read(ctx):
    return work.kernel_share(ctx, ("iaf_spikes", "iaf_deposit"), ("neuron", "intra"))
