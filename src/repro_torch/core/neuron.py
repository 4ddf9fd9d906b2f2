"""Neuron models: ``iaf_psc_exp`` LIF and the paper's *ignore-and-fire*.

Port of ``repro.core.neuron``. Both models expose the same interface, so the
engines are model-agnostic:

    state  = init(...)                              # dataclass of tensors
    state', spikes = update(state, I_in, ...)       # one dt step

The external Poisson drive is a counter-based function of ``(seed, t,
gid)``: no stateful generator is drawn from, so any schedule and any device
see bit-identical drive. ``counter_uniform`` lives beside the fused
superstep kernel that recomputes it (:mod:`repro_torch.kernels.cycle`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.cycle import counter_uniform
from repro_torch.kernels.lif_update import f32, lif_update_plain

__all__ = [
    "LIFParams",
    "LIFState",
    "lif_init",
    "lif_update",
    "IafState",
    "iaf_interval",
    "ignore_and_fire_init",
    "ignore_and_fire_update",
    "counter_uniform",
    "poisson_drive",
]

_NEVER = np.iinfo(np.int32).max // 2  # countdown of a neuron that never fires


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """iaf_psc_exp parameters (NEST defaults) + propagators for step ``dt_ms``."""

    tau_m_ms: float = 10.0
    tau_syn_ms: float = 0.5
    c_m_pf: float = 250.0
    t_ref_ms: float = 2.0
    v_th_mv: float = 15.0
    v_reset_mv: float = 0.0
    dt_ms: float = 0.1

    @property
    def p22(self) -> float:
        """V decay over one step: exp(-dt/tau_m)."""
        return float(np.exp(-self.dt_ms / self.tau_m_ms))

    @property
    def p11(self) -> float:
        """Synaptic-current decay: exp(-dt/tau_syn)."""
        return float(np.exp(-self.dt_ms / self.tau_syn_ms))

    @property
    def p21(self) -> float:
        """Exact current->voltage propagator over one step."""
        tm, ts, dt, cm = self.tau_m_ms, self.tau_syn_ms, self.dt_ms, self.c_m_pf
        if abs(tm - ts) < 1e-12:
            return float(dt / cm * np.exp(-dt / tm))
        return float(
            (tm * ts) / (cm * (tm - ts)) * (np.exp(-dt / tm) - np.exp(-dt / ts))
        )

    @property
    def t_ref_steps(self) -> int:
        return int(round(self.t_ref_ms / self.dt_ms))


@dataclasses.dataclass
class LIFState:
    v: torch.Tensor        # membrane potential, f32
    i_syn: torch.Tensor    # synaptic current, f32
    refrac: torch.Tensor   # remaining refractory steps, int32


def lif_init(shape, device) -> LIFState:
    return LIFState(
        v=torch.zeros(shape, dtype=torch.float32, device=device),
        i_syn=torch.zeros(shape, dtype=torch.float32, device=device),
        refrac=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def poisson_drive(
    seed,
    t: int,
    gids: torch.Tensor,
    rate_hz: torch.Tensor,
    dt_ms: float,
    w_ext: float,
) -> torch.Tensor:
    """Deterministic external drive current for step ``t``: each neuron gets a
    Bernoulli(dt * rate) impulse of weight ``w_ext``, keyed on (seed, t, gid);
    ``seed`` is an int or a per-neuron tensor (:func:`counter_uniform`)."""
    p = rate_hz * f32(dt_ms * 1e-3)
    u = counter_uniform(seed, t, gids)
    return (u < p).float() * f32(w_ext)


def lif_update(
    state: LIFState,
    i_in: torch.Tensor,
    alive: torch.Tensor,
    params: LIFParams,
) -> tuple[LIFState, torch.Tensor]:
    """One exact-propagator step in plain PyTorch. ``i_in`` is this step's
    ring-buffer slot (incl. external drive). Returns (state', spikes bool)."""
    v, i_syn, refrac, spikes = lif_update_plain(
        state.v, state.i_syn, state.refrac, i_in, alive,
        p11=params.p11, p21=params.p21, p22=params.p22,
        v_th=params.v_th_mv, v_reset=params.v_reset_mv,
        t_ref_steps=params.t_ref_steps)
    return LIFState(v=v, i_syn=i_syn, refrac=refrac), spikes


@dataclasses.dataclass
class IafState:
    countdown: torch.Tensor  # steps until next spike, int32


def iaf_interval(rate_hz: torch.Tensor, dt_ms: float) -> torch.Tensor:
    """Per-neuron firing interval in steps: ``round(1 / (rate * dt))`` clamped
    to >= 1; rate 0 maps to a never-fires sentinel."""
    # A true f32 division: `1000.0 / tensor` would multiply by a reciprocal.
    steps = torch.div(torch.full_like(rate_hz, 1000.0), rate_hz * f32(dt_ms))
    interval = torch.clamp(torch.round(steps).nan_to_num(posinf=0).to(torch.int32), min=1)
    return torch.where(rate_hz > 0, interval, _NEVER).to(torch.int32)


def ignore_and_fire_init(
    alive: torch.Tensor,
    rate_hz: torch.Tensor,
    dt_ms: float,
    gids: torch.Tensor,
) -> IafState:
    """Per-neuron interval = round(1 / (rate * dt)); phase = gid % interval."""
    phase = gids % iaf_interval(rate_hz, dt_ms)
    return IafState(countdown=torch.where(alive, phase, _NEVER).to(torch.int32))


def ignore_and_fire_update(
    state: IafState,
    i_in: torch.Tensor,
    alive: torch.Tensor,
    rate_hz: torch.Tensor,
    dt_ms: float,
) -> tuple[IafState, torch.Tensor]:
    """Fire when the countdown hits zero; ``i_in`` is delivered but ignored."""
    del i_in
    spikes = (state.countdown == 0) & alive
    interval = iaf_interval(rate_hz, dt_ms)
    countdown = torch.where(spikes, interval - 1, state.countdown - 1)
    return IafState(countdown=countdown.to(torch.int32)), spikes
