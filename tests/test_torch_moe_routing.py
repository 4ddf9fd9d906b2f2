"""The routing-flip rule that every MoE comparison of the port's tests uses,
and the tap that records the port's routing; no JAX, so the card tests
share them.

Routing is discontinuous: an ulp in the router can flip a near-tied top-k
choice, and capacity then moves other tokens of that sequence too. So a
comparison first holds the expert choices of the two sides to each other,
prints each sequence's first flip with its gate margin (a flip whose margin
is not a rounding's, ``FLIP_MARGIN``, fails), and holds the outputs only on
the sequences whose choices agree in every MoE layer.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models import moe

FLIP_MARGIN = 1e-5


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def agreeing_rows(got: list, want: list) -> np.ndarray:
    """``got`` / ``want``: per MoE layer (in call order), one side's and the
    other's ``(expert_idx [B, S, k], gates [B, S, E])``, numpy or torch.
    Returns the rows (sequences) whose choices agree in every layer; prints
    each row's first flip with ``want``'s gate margin, which must be a
    rounding's. A flip later in a row that already flipped is downstream of
    it and is not judged."""
    assert len(got) == len(want) and got, (len(got), len(want))
    agree = np.ones(_np(want[0][0]).shape[0], bool)
    for layer, ((gi, _), (wi, wg)) in enumerate(zip(got, want)):
        gi, wi, wg = _np(gi), _np(wi), _np(wg)
        assert gi.shape == wi.shape
        for b, s in np.argwhere((gi != wi).any(-1)):
            if not agree[b]:
                continue
            k = wi.shape[-1]
            top = np.sort(wg[b, s])[::-1][:k + 1]
            margin = float(np.min(top[:-1] - top[1:]))
            print(f"routing flip: MoE layer {layer}, row {b}, token {s}: "
                  f"{gi[b, s].tolist()} against {wi[b, s].tolist()}, gate margin {margin:.3g}")
            assert margin < FLIP_MARGIN, (layer, b, s, margin)
            agree[b] = False
    assert agree.any(), "every sequence flipped"
    return agree


def routing_tap(monkeypatch) -> list:
    """Records, in call order, each MoE layer's ``(expert_idx, gates)`` as
    numpy arrays, from the port's own ``moe.route`` inside ``moe_apply`` (no
    second routing). Callers take and clear the list between runs."""
    calls, route = [], moe.route

    def tapped(p, x, cfg):
        gates, gate_vals, idx = route(p, x, cfg)
        calls.append((_np(idx), _np(gates)))
        return gates, gate_vals, idx

    monkeypatch.setattr(moe, "route", tapped)
    return calls


# ---------------------------------------------------------------------------
# the rule itself


def _layer(b=3, s=4, e=4, k=2, seed=0):
    """Gates with clear margins (>= 0.05) and their top-k choices."""
    rng = np.random.default_rng(seed)
    gates = np.stack([rng.permutation(np.linspace(0.1, 0.25, e)) for _ in range(b * s)])
    gates = gates.reshape(b, s, e).astype(np.float32)
    return np.argsort(-gates, axis=-1, kind="stable")[..., :k], gates


def test_agreeing_rows_keeps_every_row_without_a_flip():
    idx, gates = _layer()
    assert agreeing_rows([(idx, gates)] * 2, [(idx.copy(), gates)] * 2).all()


def test_a_rounding_flip_drops_its_row_and_its_downstream_flips():
    idx, gates = _layer()
    tied = gates.copy()
    tied[1, 2, idx[1, 2, 1]] = tied[1, 2, idx[1, 2, 0]] - 1e-7  # a near tie at k
    swapped = idx.copy()
    swapped[1, 2] = idx[1, 2, ::-1]
    later = idx.copy()
    later[1, 0] = idx[1, 0, ::-1]  # at a real margin, but downstream in row 1
    rows = agreeing_rows([(swapped, tied), (later, gates)], [(idx, tied), (idx, gates)])
    assert rows.tolist() == [True, False, True]


def test_a_flip_at_a_real_gate_margin_fails():
    idx, gates = _layer()
    moved = idx.copy()
    moved[0, 1] = idx[0, 1, ::-1]
    with pytest.raises(AssertionError):
        agreeing_rows([(moved, gates)], [(idx, gates)])


def test_every_row_flipped_fails():
    idx, gates = _layer(b=1)
    tied = gates.copy()
    tied[0, 0, idx[0, 0, 1]] = tied[0, 0, idx[0, 0, 0]]
    moved = idx.copy()
    moved[0, 0] = idx[0, 0, ::-1]
    with pytest.raises(AssertionError, match="every sequence flipped"):
        agreeing_rows([(moved, tied)], [(idx, tied)])


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "grok-1-314b"])
def test_the_tap_records_each_moe_layer_once_and_changes_nothing(arch, monkeypatch):
    """One record a MoE sub-layer (llama4's reduced group of 2 holds one;
    grok's every layer is MoE), the choices and gates of that layer's
    router, and the forward bitwise the untapped one."""
    pb = get_arch(arch, reduced=True)
    gen = torch.Generator().manual_seed(0)
    params = pb.model.init_params(gen)
    toks = torch.randint(0, pb.cfg.vocab, (2, 16), generator=gen)
    with torch.inference_mode():
        want, want_aux = pb.model.forward(params, toks)
        calls = routing_tap(monkeypatch)
        got, aux = pb.model.forward(params, toks)
    n_moe = sum(pb.cfg.sub_is_moe(i) for i in range(pb.cfg.group_size)) * pb.cfg.n_groups
    assert len(calls) == n_moe > 0
    k = pb.cfg.moe.top_k
    for idx, gates in calls:
        assert idx.shape == (2, 16, k) and gates.shape == (2, 16, pb.cfg.moe.n_experts)
        chosen = np.take_along_axis(gates, idx, -1)
        assert (np.diff(chosen, axis=-1) <= 0).all()
        assert (chosen[..., -1] >= np.sort(gates, -1)[..., -k]).all()
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
