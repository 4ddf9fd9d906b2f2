"""Faults planted under the timed path, for the tests that see ``correct``
come out false (``harness.run(..., tamper="perfbench.tests.faults:<name>")``).
Each maps an engine to a broken one."""

from __future__ import annotations

import dataclasses

import torch


def _with_window(eng, window):
    return dataclasses.replace(eng, window=window)


def state_unchanged(eng):
    """Every window returns the state it was given, and no spikes."""
    def window(st):
        _, block = eng.window(st)
        return st, torch.zeros_like(block)
    return _with_window(eng, window)


def half_left_out(eng):
    """The second half of every area's neurons keeps its old state and
    ring: half the network is not simulated."""
    def window(st):
        new, block = eng.window(st)
        h = st.ring.shape[1] // 2

        def mix(old, cur):
            return torch.cat([cur[:, :h], old[:, h:]], dim=1)

        neuron = dataclasses.replace(new.neuron, **{
            f.name: mix(getattr(st.neuron, f.name), getattr(new.neuron, f.name))
            for f in dataclasses.fields(new.neuron)})
        block = block.clone()
        block[:, :, h:] = False
        return dataclasses.replace(new, neuron=neuron, ring=mix(st.ring, new.ring),
                                   spike_count=mix(st.spike_count, new.spike_count)), block
    return _with_window(eng, window)


def exchange_left_out(eng):
    """The window-end exchange between areas delivers nothing."""
    from repro_torch.core import exchange

    def window_end(self, ring, block, t0, net, gids, *, blocked):
        return ring, 0, 0.0

    exchange.LocalExchange.window_end = window_end
    return eng


def spike_altered(eng):
    """Window 3's first neuron gets a spike it did not fire (or loses one)."""
    seen = [0]

    def window(st):
        new, block = eng.window(st)
        seen[0] += 1
        if seen[0] == 3:
            block = block.clone()
            block[0, 0, 0] = ~block[0, 0, 0]
            count = new.spike_count.clone()
            count[0, 0] += 1 if bool(block[0, 0, 0]) else -1
            new = dataclasses.replace(new, spike_count=count)
        return new, block
    return _with_window(eng, window)
