"""Deterministic fault injection for preemption-tolerant simulation.

Port of ``repro.core.faults``: the same fault plan, spec grammar, error
messages and draws (keyed by ``np.random.default_rng((seed, window))``), so
an injected run here sleeps through the reference's straggler sequence.

A brain-scale run is hours long on thousands of devices; the extreme form of
the paper's straggler problem is a *preempted or dead node*, and the
communication layer's own failure modes (overflow, transient I/O loss --
cf. Du et al., "A Low-latency Communication Design for Brain Simulations")
should be conditions to degrade through, not crash on. This module makes
those conditions reproducible on a laptop:

* **compute jitter** -- per-device, per-cycle compute times drawn from
  :class:`repro_torch.core.sync_model.CycleTimeModel` (the paper's §2.2 generative
  model), lumped over the D-cycle window and *slept* for on the host: the
  run's wall clock becomes ``max`` over simulated devices, exactly the
  order-statistics regime the sync model predicts. Samples are keyed by
  ``(seed, window)`` so a resumed run sees the same straggler sequence as an
  uninterrupted one.
* **transient checkpoint-write failures** -- the first ``k`` saves raise
  ``OSError``, exercising :class:`repro_torch.checkpoint.manager.AsyncWriter`'s
  bounded-retry/backoff path end to end.
* **simulated preemption** -- a SIGTERM-style :class:`Preempted` raised at a
  chosen window boundary; the windowed run loop
  (:func:`repro_torch.core.schedule.run_windows`) writes a final checkpoint and
  re-raises, so kill-at-window-k / resume flows are a single flag.

Everything here is host-side and deterministic; nothing runs inside the
window body.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np

from repro_torch.core import sync_model

__all__ = [
    "FaultConfig",
    "FaultInjector",
    "Preempted",
    "format_fault_specs",
    "parse_fault_specs",
    "predicted_window_comm_jitter_s",
    "predicted_window_jitter_s",
]


class Preempted(RuntimeError):
    """Simulated SIGTERM: raised at a window boundary by the fault harness.

    ``window`` is the 1-based count of completed windows (== the checkpoint
    step id written at that boundary, if checkpointing is on).
    """

    def __init__(self, window: int, checkpoint_path: str | None = None):
        self.window = window
        self.checkpoint_path = checkpoint_path
        where = f" (checkpoint: {checkpoint_path})" if checkpoint_path else ""
        super().__init__(
            f"simulated preemption after window {window}{where}")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Declarative fault plan, carried on ``EngineConfig.faults``.

    All zeros/negatives = that fault disabled; the default instance injects
    nothing. Jitter times are in milliseconds (the sync model's natural
    unit); ``jitter_devices=0`` means "use the real device count" (resolved
    by the injector).
    """

    # Per-device compute jitter (sync_model.CycleTimeModel body + AR(1)).
    jitter_mu_ms: float = 0.0
    jitter_sigma_ms: float = 0.0
    jitter_rho: float = 0.0
    jitter_devices: int = 0
    # Per-window *exchange* (communication) jitter: one N(mu, sigma^2) draw
    # per simulated device per window, maxed over devices. The overlapped
    # schedule hides this behind the next window's compute (wall tracks
    # max(compute, comm)); the sequential schedule pays the sum.
    comm_mu_ms: float = 0.0
    comm_sigma_ms: float = 0.0
    # Transient checkpoint-write failures: the first k saves raise OSError.
    ckpt_write_failures: int = 0
    # Simulated preemption after this many *completed* windows (1-based;
    # <= 0 disables). Counted in absolute windows (resume-aware): a run
    # resumed at window 10 with preempt_after_window=12 dies 2 windows in.
    preempt_after_window: int = 0
    seed: int = 0

    @property
    def jitter_enabled(self) -> bool:
        return self.jitter_mu_ms > 0 or self.jitter_sigma_ms > 0

    @property
    def comm_enabled(self) -> bool:
        return self.comm_mu_ms > 0 or self.comm_sigma_ms > 0

    @property
    def any_enabled(self) -> bool:
        return (self.jitter_enabled or self.comm_enabled
                or self.ckpt_write_failures > 0
                or self.preempt_after_window > 0)

    def cycle_time_model(self) -> sync_model.CycleTimeModel:
        return sync_model.CycleTimeModel(
            mu=self.jitter_mu_ms * 1e-3,
            sigma=self.jitter_sigma_ms * 1e-3,
            rho=self.jitter_rho,
        )


def predicted_window_jitter_s(
    model: sync_model.CycleTimeModel, n_devices: int, d: int
) -> float:
    """Analytic E[window straggler time]: paper eqs. (6)+(8) per window.

    Lumping D cycles turns per-device window time into N(D mu, D sigma^2);
    the expected maximum over M devices is ``D mu + sqrt(D) sigma xi_M``
    (Blom). :meth:`FaultInjector.window_jitter_s` draws from the same model,
    so measured window times under injected jitter must converge to this --
    the validation the resilience tests pin.
    """
    return d * model.mu + math.sqrt(d) * model.sigma * sync_model.blom_xi(
        n_devices)


def predicted_window_comm_jitter_s(
    comm_mu_s: float, comm_sigma_s: float, n_devices: int
) -> float:
    """Analytic E[window exchange straggler]: max over M of N(mu, sigma^2).

    The exchange happens once per window (not per cycle), so the lumping
    factor is 1; the expected maximum over the M participating devices is
    ``mu + sigma xi_M`` (Blom), same order-statistics form as the compute
    prediction.
    """
    return comm_mu_s + comm_sigma_s * sync_model.blom_xi(n_devices)


class FaultInjector:
    """Runtime arm of a :class:`FaultConfig` for one run (or one resume leg).

    Stateless across windows except the transient-write counter; jitter is a
    pure function of ``(seed, window)`` so interrupted and uninterrupted runs
    sleep through identical straggler sequences.
    """

    def __init__(self, cfg: FaultConfig, *, n_devices: int, delay_ratio: int):
        self.cfg = cfg
        self.n_devices = cfg.jitter_devices or n_devices
        self.delay_ratio = delay_ratio
        self.model = cfg.cycle_time_model()
        self.injected_sleep_s = 0.0
        self.windows_slept = 0
        self._ckpt_fails_left = cfg.ckpt_write_failures
        self.ckpt_failures_injected = 0

    # -- compute jitter ----------------------------------------------------

    def window_jitter_s(self, window: int) -> float:
        """Straggler time for one window: max over simulated devices of the
        D-cycle lumped draw from the cycle-time model."""
        if not self.cfg.jitter_enabled:
            return 0.0
        rng = np.random.default_rng((self.cfg.seed, int(window)))
        t = self.model.sample(self.n_devices, self.delay_ratio, rng)
        return float(t.sum(axis=1).max())

    def window_comm_jitter_s(self, window: int) -> float:
        """Exchange straggler time for one window: max over simulated devices
        of one N(comm_mu, comm_sigma^2) draw. Keyed by ``(seed, window)``
        with a salt so the comm draw is independent of the compute draw --
        both are pure functions of the window index, so interrupted,
        resumed, sequential and pipelined runs all see the *same* realized
        straggler sequence (what makes the max-vs-sum assertions exact)."""
        if not self.cfg.comm_enabled:
            return 0.0
        rng = np.random.default_rng((self.cfg.seed, int(window), 0x0C))
        t = (self.cfg.comm_mu_ms
             + self.cfg.comm_sigma_ms * rng.standard_normal(self.n_devices))
        return max(float(t.max()) * 1e-3, 0.0)

    def inject(self, seconds: float) -> float:
        """Sleep ``seconds`` on the host and account for it; returns it."""
        if seconds > 0:
            time.sleep(seconds)
            self.injected_sleep_s += seconds
            self.windows_slept += 1
        return seconds

    def sleep(self, window: int) -> float:
        """Inject the window's compute straggler time as a host sleep."""
        return self.inject(self.window_jitter_s(window))

    def predicted_jitter_s(self) -> float:
        """The sync model's per-window prediction for this injector's shape."""
        return predicted_window_jitter_s(
            self.model, self.n_devices, self.delay_ratio)

    def predicted_comm_s(self) -> float:
        """Per-window exchange-straggler prediction (0 when comm disabled)."""
        if not self.cfg.comm_enabled:
            return 0.0
        return predicted_window_comm_jitter_s(
            self.cfg.comm_mu_ms * 1e-3, self.cfg.comm_sigma_ms * 1e-3,
            self.n_devices)

    def predicted_sequential_s(self) -> float:
        """Per-window injected wall under the sequential schedule: the SUM of
        the compute and exchange straggler times (both on the critical
        path)."""
        return self.predicted_jitter_s() + self.predicted_comm_s()

    def predicted_overlap_s(self) -> float:
        """Per-window injected wall under the pipelined schedule: E[max] of
        the compute and exchange stragglers (Clark), the paper's
        max(compute, comm) claim in closed form. The straggler *spread*
        (std of the max over M devices) is approximated by the per-device
        sigma -- an upper bound that only matters when the two means are
        close."""
        m1 = self.predicted_jitter_s()
        s1 = math.sqrt(self.delay_ratio) * self.model.sigma
        m2 = self.predicted_comm_s()
        s2 = self.cfg.comm_sigma_ms * 1e-3
        return sync_model.expected_max_normals(m1, s1, m2, s2)

    # -- preemption --------------------------------------------------------

    def preempt_now(self, windows_done: int) -> bool:
        """True when the SIGTERM-style stop fires (after `windows_done`)."""
        return (self.cfg.preempt_after_window > 0
                and windows_done >= self.cfg.preempt_after_window)

    # -- transient checkpoint-write failures -------------------------------

    def wrap_save(self, save_fn: Callable[..., str]) -> Callable[..., str]:
        """A ``save_fn`` whose first k calls raise OSError, then delegate.

        Handed to ``AsyncWriter(save_fn=...)`` so the writer's bounded
        retry/backoff path runs against a deterministic failure budget.
        """

        def flaky_save(directory, step, tree, *, extra=None):
            if self._ckpt_fails_left > 0:
                self._ckpt_fails_left -= 1
                self.ckpt_failures_injected += 1
                raise OSError(
                    f"injected transient checkpoint-write failure "
                    f"({self.ckpt_failures_injected}"
                    f"/{self.cfg.ckpt_write_failures})")
            return save_fn(directory, step, tree, extra=extra)

        return flaky_save


def _pop_number(kv: dict, key: str, default, spec: str, conv):
    """Pop ``key`` from ``kv`` and convert with ``conv``, with context on a
    bad numeric literal (a raw ``float('x')`` error names neither the option
    nor the spec -- exactly the silent-misconfiguration trap this grammar
    exists to close)."""
    raw = kv.pop(key, None)
    if raw is None:
        return default
    try:
        return conv(raw)
    except ValueError:
        raise ValueError(
            f"bad value {raw!r} for option {key!r} in fault spec {spec!r} "
            f"(expected {conv.__name__})") from None


def parse_fault_specs(specs: list[str] | None, *, seed: int = 0) -> FaultConfig:
    """Parse ``--inject-fault`` CLI specs into one :class:`FaultConfig`.

    Grammar (repeatable, later specs merge over earlier ones)::

        jitter:mu_ms=1.6,sigma_ms=0.3[,comm_mu_ms=..][,comm_sigma_ms=..]
              [,rho=0.5][,devices=8]
        ckpt-io:fails=2
        preempt:window=12

    Round-trips with :func:`format_fault_specs`; every malformed input --
    unknown kind, unknown or missing option, bad numeric literal, or a
    ``jitter:`` spec that sets nothing -- raises ``ValueError`` naming the
    offending spec.
    """
    cfg = FaultConfig(seed=seed)
    for spec in specs or ():
        kind, _, body = spec.partition(":")
        kv = {}
        for part in filter(None, body.split(",")):
            k, eq, v = part.partition("=")
            if not eq:
                raise ValueError(f"bad fault option {part!r} in {spec!r}")
            kv[k] = v
        try:
            if kind == "jitter":
                if not kv:
                    raise ValueError(
                        f"fault spec {spec!r} sets no options (a bare "
                        f"'jitter' would silently disable the harness); "
                        f"expected e.g. jitter:mu_ms=1.6,sigma_ms=0.3")
                cfg = dataclasses.replace(
                    cfg,
                    jitter_mu_ms=_pop_number(
                        kv, "mu_ms", cfg.jitter_mu_ms, spec, float),
                    jitter_sigma_ms=_pop_number(
                        kv, "sigma_ms", cfg.jitter_sigma_ms, spec, float),
                    comm_mu_ms=_pop_number(
                        kv, "comm_mu_ms", cfg.comm_mu_ms, spec, float),
                    comm_sigma_ms=_pop_number(
                        kv, "comm_sigma_ms", cfg.comm_sigma_ms, spec, float),
                    jitter_rho=_pop_number(
                        kv, "rho", cfg.jitter_rho, spec, float),
                    jitter_devices=_pop_number(
                        kv, "devices", cfg.jitter_devices, spec, int),
                )
            elif kind == "ckpt-io":
                if "fails" not in kv:
                    raise KeyError("fails")
                cfg = dataclasses.replace(cfg, ckpt_write_failures=_pop_number(
                    kv, "fails", 0, spec, int))
            elif kind == "preempt":
                if "window" not in kv:
                    raise KeyError("window")
                cfg = dataclasses.replace(cfg, preempt_after_window=_pop_number(
                    kv, "window", 0, spec, int))
            else:
                raise ValueError(
                    f"unknown fault kind {kind!r} (expected jitter | "
                    f"ckpt-io | preempt)")
        except KeyError as e:
            raise ValueError(f"fault spec {spec!r} missing option {e}") from e
        if kv:
            raise ValueError(
                f"unknown option(s) {sorted(kv)} for fault kind {kind!r}")
    return cfg


def format_fault_specs(cfg: FaultConfig) -> list[str]:
    """Inverse of :func:`parse_fault_specs` (modulo ``seed``, which is a CLI
    flag, not part of the spec grammar): emits one spec per enabled fault
    such that ``parse_fault_specs(format_fault_specs(cfg), seed=cfg.seed)
    == cfg``. Used to echo the active fault plan (resume hints, logs) in a
    form that can be pasted straight back onto ``--inject-fault``."""
    specs: list[str] = []
    jitter_opts = []
    base = FaultConfig()
    for opt, field in (("mu_ms", "jitter_mu_ms"),
                       ("sigma_ms", "jitter_sigma_ms"),
                       ("comm_mu_ms", "comm_mu_ms"),
                       ("comm_sigma_ms", "comm_sigma_ms"),
                       ("rho", "jitter_rho"),
                       ("devices", "jitter_devices")):
        val = getattr(cfg, field)
        if val != getattr(base, field):
            jitter_opts.append(f"{opt}={val!r}")
    if jitter_opts:
        specs.append("jitter:" + ",".join(jitter_opts))
    if cfg.ckpt_write_failures > 0:
        specs.append(f"ckpt-io:fails={cfg.ckpt_write_failures}")
    if cfg.preempt_after_window > 0:
        specs.append(f"preempt:window={cfg.preempt_after_window}")
    return specs
