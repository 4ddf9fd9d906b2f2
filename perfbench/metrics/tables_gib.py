"""The bytes of the built network's tensors (the synapse tables, incoming
and, where the route builds them, outgoing), in GiB."""


def read(ctx):
    return ctx.tables_bytes / 2**30
