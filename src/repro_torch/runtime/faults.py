"""Fault injection: deterministic failure scenarios on a simulated
multi-host clock; the port of ``repro/runtime/faults.py`` (numpy only, so
the port keeps its own copy, the same names and the same numbers).

The cluster-membership controller (:mod:`repro_torch.runtime.controller`)
is driven by three inputs that on a real fleet come from the outside
world: per-host step times, step exceptions, and preemption signals.  This
module synthesizes all three deterministically, so the straggler → evict →
rebalance → resume loop runs end to end on ranks of one machine:

- :class:`SlowHost` — one host's step time is inflated by ``factor`` from
  ``start_step`` (optionally until ``end_step``): the failing-HBM /
  thermal-throttle / noisy-neighbour case that straggler eviction targets.
- :class:`DriftHost` — a *gradual* linear slowdown ramp that stays under
  the straggler monitor's outlier threshold; the case that drift-triggered
  recalibration catches and one-shot eviction does not.
- :class:`CrashStep` — the step function raises a transient
  ``RuntimeError`` ``times`` times at ``step`` (a network flake, a failed
  reduction); exercised against :class:`FaultTolerantLoop`'s bounded
  retry, which must replay the *same* batch (exactly-once data).
- :class:`Preemption` — SIGTERM is delivered to the process before
  ``step`` (a maintenance event), exercising the final-synchronous-
  checkpoint path.  Every rank of a job delivers it at the same step, so
  the final checkpoint stays collective.
- :class:`SpotPreemption` — the *membership* flavour: a spot reclaim
  notice for one host at ``warn_step`` with the host vanishing
  ``deadline_steps`` later, exercising the controller's
  drain-within-deadline path (and the fall-back-to-last-checkpoint path
  when the deadline is missed).
- :class:`JoinHost` — a host *offers* capacity at ``step`` (scale-up /
  spot re-admission), exercising the symmetric grow path.

Per-host times are a pure function of ``(seed, step, host)``: the same
scenario always produces the same timeline, on every rank.
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class SlowHost:
    """Host ``host`` runs ``factor``× slower from ``start_step`` on."""
    host: int
    start_step: int
    factor: float = 3.0
    end_step: int | None = None     # None = slow forever (until evicted)

    def active(self, step: int) -> bool:
        return (step >= self.start_step
                and (self.end_step is None or step < self.end_step))


@dataclasses.dataclass(frozen=True)
class DriftHost:
    """Host ``host`` slows *gradually*: 1× at ``start_step`` ramping
    linearly to ``factor``× at ``end_step``, then holding.

    The calibration adversary (DESIGN.md §10): a slow ramp stays inside
    the straggler monitor's outlier band at every individual step (the
    EMA tracks the drift), so one-shot eviction never fires — only the
    predicted-vs-measured skew accumulated by the profiler exposes it.
    """
    host: int
    start_step: int
    end_step: int
    factor: float = 3.0

    def factor_at(self, step: int) -> float:
        if step <= self.start_step:
            return 1.0
        if step >= self.end_step:
            return self.factor
        frac = (step - self.start_step) / (self.end_step - self.start_step)
        return 1.0 + frac * (self.factor - 1.0)


@dataclasses.dataclass(frozen=True)
class CrashStep:
    """The step raises a transient error ``times`` times at ``step``."""
    step: int
    times: int = 1
    message: str = "injected transient step failure"


@dataclasses.dataclass(frozen=True)
class Preemption:
    """SIGTERM is delivered immediately before ``step`` runs."""
    step: int


@dataclasses.dataclass(frozen=True)
class SpotPreemption:
    """Spot reclaim: the scheduler warns at ``warn_step`` that ``host``
    disappears ``deadline_steps`` later.

    ``deadline_steps=0`` models a missed/zero notice — the warning and
    the loss land on the same step, so the controller cannot commit a
    drain checkpoint and must fall back to the last committed one.
    """
    host: int
    warn_step: int
    deadline_steps: int = 2


@dataclasses.dataclass(frozen=True)
class JoinHost:
    """A host offers ``n_devices`` devices of ``hw`` from ``step`` on
    (scale-up, or a spot pool re-admitting reclaimed capacity).  A
    ``hw`` of None takes the consuming fleet's default hardware."""
    host: int
    step: int
    n_devices: int
    hw: Any = None


@dataclasses.dataclass
class FaultInjector:
    """Deterministic scenario playback for the training controller.

    ``host_times(step, base)`` is the simulated multi-host clock: every
    host reports ``base`` (the measured or nominal step time) perturbed
    by a small deterministic jitter, with active :class:`SlowHost`
    scenarios multiplied in.  ``maybe_fail`` / ``maybe_preempt`` are
    called by the controller's step function / loop hooks.
    """
    scenarios: tuple = ()
    n_hosts: int = 1
    jitter: float = 0.02            # relative σ of per-host noise
    seed: int = 0
    # nominal step time: when set, host_times ignores the measured base
    # entirely — the whole timeline becomes a pure function of (seed,
    # step, host), immune to load spikes on the machine running the
    # simulation (CI runners flagging the wrong host)
    nominal: float | None = None

    def __post_init__(self):
        self.scenarios = tuple(self.scenarios)
        self._crash_budget = {
            id(s): s.times for s in self.scenarios
            if isinstance(s, CrashStep)}
        self._preempted: set = set()
        self._membership_fired: set = set()

    # --- simulated multi-host clock ---
    def slow_factor(self, step: int, host: int) -> float:
        f = 1.0
        for s in self.scenarios:
            if isinstance(s, SlowHost) and s.host == host and s.active(step):
                f *= s.factor
            elif isinstance(s, DriftHost) and s.host == host:
                f *= s.factor_at(step)
        return f

    def host_times(self, step: int, base: float = 1.0,
                   hosts=None) -> dict:
        """host_id → simulated step time at ``step``.

        Deterministic in ``(seed, step, host)``: replaying a scenario
        (e.g. the naive vs self-healing arms of fig_elastic) sees the
        identical timeline.
        """
        if self.nominal is not None:
            base = self.nominal
        hosts = range(self.n_hosts) if hosts is None else hosts
        out = {}
        for h in hosts:
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 1_000_003 + h)
            noise = 1.0 + self.jitter * float(rng.standard_normal())
            out[h] = base * max(noise, 0.1) * self.slow_factor(step, h)
        return out

    # --- step failures ---
    def maybe_fail(self, step: int) -> None:
        """Raise the scenario's transient error while its budget lasts."""
        for s in self.scenarios:
            if isinstance(s, CrashStep) and s.step == step:
                if self._crash_budget.get(id(s), 0) > 0:
                    self._crash_budget[id(s)] -= 1
                    raise RuntimeError(f"{s.message} (step {step})")

    # --- cluster membership (DESIGN.md §12) ---
    def membership(self, step: int) -> list:
        """Membership signals due by ``step``: ``(kind, scenario)`` pairs.

        Kinds are ``"preempt_warn"`` / ``"host_lost"`` (from
        :class:`SpotPreemption`) and ``"join"`` (from :class:`JoinHost`).
        Each signal fires **exactly once** — ``>=`` comparisons mean a
        signal whose step fell inside a rebalance window still delivers
        at the next polled step.  The caller grounds signals against its
        live topology (a host shed before its deadline never *acts on*
        ``host_lost``; the one-shot here still consumes it).
        """
        out = []
        for s in self.scenarios:
            if isinstance(s, SpotPreemption):
                if step >= s.warn_step \
                        and ("warn", id(s)) not in self._membership_fired:
                    self._membership_fired.add(("warn", id(s)))
                    out.append(("preempt_warn", s))
                if step >= s.warn_step + s.deadline_steps \
                        and ("lost", id(s)) not in self._membership_fired:
                    self._membership_fired.add(("lost", id(s)))
                    out.append(("host_lost", s))
            elif isinstance(s, JoinHost):
                if step >= s.step \
                        and ("join", id(s)) not in self._membership_fired:
                    self._membership_fired.add(("join", id(s)))
                    out.append(("join", s))
        return out

    # --- preemption ---
    def maybe_preempt(self, step: int) -> None:
        """Deliver SIGTERM to ourselves once per Preemption scenario."""
        for s in self.scenarios:
            if isinstance(s, Preemption) and s.step == step \
                    and id(s) not in self._preempted:
                self._preempted.add(id(s))
                os.kill(os.getpid(), signal.SIGTERM)

    # --- the one-shot marks, across processes ---
    def state_dict(self) -> dict:
        """The crash budgets and one-shot marks by scenario index (the
        marks' own keys are object ids, which differ between processes):
        what another process's injector over the same scenarios needs to
        play on from here (:meth:`load_state_dict`)."""
        idx = {id(s): n for n, s in enumerate(self.scenarios)}
        return {"crash": {idx[k]: v for k, v in self._crash_budget.items()},
                "preempted": sorted(idx[k] for k in self._preempted),
                "fired": sorted((kind, idx[k])
                                for kind, k in self._membership_fired)}

    def load_state_dict(self, state: dict) -> None:
        ids = [id(s) for s in self.scenarios]
        self._crash_budget = {ids[n]: v for n, v in state["crash"].items()}
        self._preempted = {ids[n] for n in state["preempted"]}
        self._membership_fired = {(kind, ids[n])
                                  for kind, n in state["fired"]}


@dataclasses.dataclass
class SimClock:
    """Accumulates simulated wall-clock: a synchronous step takes as long
    as its slowest participating host."""
    t: float = 0.0
    steps: int = 0

    def advance(self, host_times: dict) -> float:
        dt = max(host_times.values())
        self.t += dt
        self.steps += 1
        return dt

    def charge(self, seconds: float) -> None:
        """Account non-step downtime (checkpoint restore, re-compile)."""
        self.t += seconds
