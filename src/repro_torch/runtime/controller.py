"""Event-driven cluster-membership runtime; the port of
``repro/runtime/controller.py``.

Whale's resource-adaptability story (§5) is bidirectional: a production
fleet both loses capacity (stragglers, spot reclaims, dead hosts) and
gains it (hosts joining, spot re-admission).  This module is the one
control loop that handles every case:

- **Typed events** — :class:`StragglerSustained`, :class:`DriftSustained`,
  :class:`PreemptionWarning`, :class:`HostLost`, :class:`HostJoin` — are
  produced by pluggable *sources* (:class:`StragglerSource` over the
  per-host monitors, :class:`DriftSource` over the predicted-vs-measured
  skew watch, :class:`InjectorSource` over the fault injector's scenario
  playback; a real deployment adds a scheduler-API source).
- **A small state machine** — RUNNING → DRAINING → REBALANCING → RESUMING
  → RUNNING, with terminal DONE / PREEMPTED / FAILED — serialises
  concurrent membership signals: events folding into the *pending*
  :class:`MembershipChange` while draining, deferring while a change is
  being applied, and raising :class:`IllegalTransition` everywhere else.
- **One apply path** — :meth:`ClusterController.apply_membership_change`
  is the only place the fleet reshapes: evictions shrink the
  :class:`~repro_torch.runtime.elastic.HostTopology`, admissions grow it
  (``with_host``), recalibration re-fits the hardware tables, and the
  tail is identical for all of them — form the next generation of the
  process group, re-plan with the hetero-aware search, restore the
  committed checkpoint into the new plan, reshard the data stream,
  resume.  There is deliberately no evict-vs-grow branch anywhere else.

The drain discipline for spot reclaim: a :class:`PreemptionWarning`
carries the step deadline by which the host vanishes; the controller
stops the segment with a final synchronous checkpoint (one step — well
inside real spot notice windows), sheds the host, and re-plans on the
survivors.  If the host dies *before* the drain commits
(:class:`HostLost`), the in-flight state is untrusted: the loop aborts
**without** a final save and the apply path restores the last committed
checkpoint, replaying the lost steps exactly-once (the data pipeline
position is part of the checkpoint, and batches are a pure function of
the step).

SPMD over generations of the process group.  The reference is one
process; here every launch rank runs the same controller and takes the
same decision at the same step: with an injector on its nominal clock
the host times are a pure function of the step, and otherwise each
rank's measured step time is all-gathered once a step (a host's time is
the max over its ranks).  Each plan runs on a generation of the default
group of exactly its ranks (:func:`~repro_torch.launch.mesh.
form_generation`), numbered in the topology's host order, so the
checkpoint's writer and gather root is always the first member's rank.
A rank outside the plan — a spare at launch, or a rank whose host left —
waits outside every group on the launch store for a ticket: an admission
(the controller's state, so it joins the next generation where the
members are) or the end of the run.  It is kept rather than ended
because first-fit (:meth:`HostTopology.with_host`) may hand a vacated
range to a joining host, as the reference hands the vacated devices.  At
the end every launch rank forms one last generation over the whole
launch world, so a run leaves the process group as it found it.
"""
from __future__ import annotations

import dataclasses
import pickle
import time
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core.cost_model import step_cost, step_cost_features
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import form_generation, launch_world
from repro_torch.runtime.elastic import (ElasticContext, HostTopology,
                                         SimHost, plan_for_cluster)
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.profiler import Profiler
from repro_torch.runtime.straggler import HostStragglerAggregator


# ---------------------------------------------------------------------------
# typed cluster events
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    """Base: something happened to the fleet at ``step``."""
    step: int


@dataclasses.dataclass(frozen=True)
class StragglerSustained(ClusterEvent):
    """``host`` has been a sustained step-time outlier (evict it)."""
    host: int
    dt: float = 0.0


@dataclasses.dataclass(frozen=True)
class DriftSustained(ClusterEvent):
    """Measured/predicted step-cost skew held above threshold (re-fit
    the hardware tables and re-plan; no host is evicted)."""
    skew: float


@dataclasses.dataclass(frozen=True)
class PreemptionWarning(ClusterEvent):
    """The scheduler reclaims ``host`` at ``deadline_step`` (spot/TPU
    maintenance notice): drain and shed it before then."""
    host: int
    deadline_step: int


@dataclasses.dataclass(frozen=True)
class HostLost(ClusterEvent):
    """``host`` vanished without a successful drain: the in-flight
    segment state is untrusted — fall back to the last committed
    checkpoint."""
    host: int


@dataclasses.dataclass(frozen=True)
class HostJoin(ClusterEvent):
    """``host`` (a :class:`SimHost`: id, hardware, device count) offers
    capacity — scale-up or spot re-admission."""
    host: SimHost


# ---------------------------------------------------------------------------
# the membership change a batch of events folds into
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MembershipChange:
    """The net fleet delta one REBALANCING pass applies.

    Events arriving while a segment drains merge here — a straggler flag
    and a preemption warning in the same segment become one evict set and
    one re-plan, not two serial rebalances.
    """
    evict: tuple = ()               # host ids leaving
    admit: tuple = ()               # SimHosts joining
    recalibrate: float = 0.0        # sustained skew (0.0 = no re-fit)
    abort: bool = False             # drain failed: restore last commit
    deadline_step: int | None = None
    reasons: tuple = ()             # event class names, for the log

    @property
    def is_noop(self) -> bool:
        return not (self.evict or self.admit or self.recalibrate)

    def merged(self, other: "MembershipChange") -> "MembershipChange":
        admit = list(self.admit)
        admit += [h for h in other.admit
                  if h.host not in {a.host for a in admit}]
        deadlines = [d for d in (self.deadline_step, other.deadline_step)
                     if d is not None]
        return MembershipChange(
            evict=tuple(dict.fromkeys(self.evict + other.evict)),
            admit=tuple(admit),
            recalibrate=max(self.recalibrate, other.recalibrate),
            abort=self.abort or other.abort,
            deadline_step=min(deadlines) if deadlines else None,
            reasons=self.reasons + other.reasons)


def change_for(event: ClusterEvent) -> MembershipChange:
    """The membership delta one event implies (pure; policy lives in
    :meth:`ClusterController._accept`)."""
    reason = (type(event).__name__,)
    if isinstance(event, StragglerSustained):
        return MembershipChange(evict=(event.host,), reasons=reason)
    if isinstance(event, DriftSustained):
        return MembershipChange(recalibrate=event.skew, reasons=reason)
    if isinstance(event, PreemptionWarning):
        return MembershipChange(evict=(event.host,),
                                deadline_step=event.deadline_step,
                                reasons=reason)
    if isinstance(event, HostLost):
        return MembershipChange(evict=(event.host,), abort=True,
                                reasons=reason)
    if isinstance(event, HostJoin):
        return MembershipChange(admit=(event.host,), reasons=reason)
    raise TypeError(f"not a ClusterEvent: {event!r}")


# ---------------------------------------------------------------------------
# state machine
# ---------------------------------------------------------------------------

RUNNING = "RUNNING"
DRAINING = "DRAINING"
REBALANCING = "REBALANCING"
RESUMING = "RESUMING"
DONE = "DONE"
PREEMPTED = "PREEMPTED"
FAILED = "FAILED"

TERMINAL = frozenset({DONE, PREEMPTED, FAILED})

_TRANSITIONS = {
    RUNNING: frozenset({DRAINING, DONE, PREEMPTED, FAILED}),
    DRAINING: frozenset({REBALANCING, DONE, PREEMPTED, FAILED}),
    REBALANCING: frozenset({RESUMING, FAILED}),
    RESUMING: frozenset({RUNNING, FAILED}),
    DONE: frozenset(),
    PREEMPTED: frozenset(),
    FAILED: frozenset(),
}


class IllegalTransition(RuntimeError):
    """A state change (or an event delivery) the machine forbids."""


@dataclasses.dataclass
class MembershipStateMachine:
    """Pure control state: where the run is, and what change is pending.

    ``on_event`` folds a :class:`ClusterEvent` in according to the
    current state — RUNNING starts a drain, DRAINING merges, REBALANCING
    and RESUMING defer the event to the next segment (a change is being
    applied; topology-relative decisions would race it), and terminal
    states raise.  The controller owns *policy* (budgets, min-hosts);
    the machine owns *sequencing*.
    """
    state: str = RUNNING
    pending: MembershipChange = dataclasses.field(
        default_factory=MembershipChange)
    deferred: tuple = ()

    def to(self, new_state: str) -> None:
        if new_state not in _TRANSITIONS[self.state]:
            raise IllegalTransition(
                f"{self.state} → {new_state} is not a legal controller "
                f"transition (allowed: "
                f"{sorted(_TRANSITIONS[self.state]) or 'none — terminal'})")
        self.state = new_state

    def on_event(self, event: ClusterEvent) -> bool:
        """Fold ``event`` in; True when the running segment must stop."""
        if self.state in TERMINAL:
            raise IllegalTransition(
                f"{type(event).__name__} delivered in terminal state "
                f"{self.state}")
        if self.state in (REBALANCING, RESUMING):
            self.deferred = self.deferred + (event,)
            return False
        self.pending = self.pending.merged(change_for(event))
        if self.state == RUNNING:
            self.to(DRAINING)
        return True

    def take(self) -> MembershipChange:
        """The pending change, clearing it (DRAINING → REBALANCING)."""
        change, self.pending = self.pending, MembershipChange()
        return change

    def take_deferred(self) -> tuple:
        events, self.deferred = self.deferred, ()
        return events


# ---------------------------------------------------------------------------
# event sources
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerSource:
    """Per-host sustained-outlier detection → :class:`StragglerSustained`."""
    aggregator: HostStragglerAggregator

    def poll(self, step: int, times: dict, topology: HostTopology) -> list:
        return [StragglerSustained(step=step, host=h, dt=times[h])
                for h in self.aggregator.observe(times)]


@dataclasses.dataclass
class DriftSource:
    """Predicted-vs-measured skew watch (DESIGN.md §10) →
    :class:`DriftSustained`.

    The first ``min_steps`` measured steps of each plan segment anchor
    the cost model's time scale (absorbing the clock's units and the
    constant modelling bias); afterwards each step feeds the profiler
    per-group observations in anchored units and ``patience`` consecutive
    steps with relative skew above ``1 + skew`` fire the event, once per
    segment.  :meth:`rearm` resets for the next plan.
    """
    cfg: "CalibrationConfig"
    profiler: Profiler

    def __post_init__(self):
        self.rearm({}, 0.0)

    def rearm(self, features: dict, predicted: float) -> None:
        self._feats = features
        self._pred = predicted
        self._n = 0
        self._sum = 0.0
        self._anchor = None
        self._hot = 0
        self._fired = False

    def poll(self, step: int, times: dict, topology: HostTopology) -> list:
        if self._fired or self._pred <= 0.0:
            return []
        measured = max(times.values())
        self._n += 1
        if self._n <= self.cfg.min_steps:
            self._sum += measured
            if self._n == self.cfg.min_steps:
                self._anchor = (self._sum / self.cfg.min_steps) / self._pred
            return []
        for gname, (feats, _pred, members) in self._feats.items():
            t_g = max((times[h] for h in members if h in times), default=0.0)
            if t_g > 0.0:
                self.profiler.record_step(gname, t_g / self._anchor, feats,
                                          step=step)
        skew = measured / (self._pred * self._anchor)
        self._hot = self._hot + 1 if skew > 1.0 + self.cfg.skew else 0
        if self._hot >= self.cfg.patience:
            self._fired = True
            return [DriftSustained(step=step, skew=skew)]
        return []


@dataclasses.dataclass
class InjectorSource:
    """Scenario playback → membership events (spot warn/lost, joins).

    The injector fires each signal exactly once; this source grounds it
    against the *live* topology — a host shed before its deadline never
    emits :class:`HostLost`, and a join for an already-present host id is
    dropped.
    """
    injector: FaultInjector
    default_hw: Any = None          # hardware for joins that name none

    def poll(self, step: int, times: dict, topology: HostTopology) -> list:
        events = []
        for kind, sc in self.injector.membership(step):
            if kind == "preempt_warn" and sc.host in topology.host_ids:
                events.append(PreemptionWarning(
                    step=step, host=sc.host,
                    deadline_step=sc.warn_step + sc.deadline_steps))
            elif kind == "host_lost" and sc.host in topology.host_ids:
                events.append(HostLost(step=step, host=sc.host))
            elif kind == "join" and sc.host not in topology.host_ids:
                events.append(HostJoin(step=step, host=SimHost(
                    sc.host, sc.hw or self.default_hw, sc.n_devices)))
        return events


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibrationConfig:
    """Knobs for the drift-triggered rebalance loop (DESIGN.md §10).

    The controller anchors the cost model's time scale to the first
    ``min_steps`` measured steps of each plan (median measured / predicted
    — absorbing the simulated clock's arbitrary units and constant
    modelling bias), then watches the *relative* skew
    ``measured / (predicted · anchor)``.  ``patience`` consecutive steps
    above ``1 + skew`` trigger a recalibration: the profiler's windowed
    observations re-fit each group's ``Hardware`` table and
    ``ElasticContext.rebalance(hardware=...)`` re-plans with measured
    rates — no host is evicted.  ``max_rebalances=0`` records
    observations (``--profile``) without ever rebalancing.
    """
    skew: float = 0.25
    patience: int = 5
    min_steps: int = 8
    window: int = 256               # observations per group fed to each fit
    max_rebalances: int = 2


@dataclasses.dataclass
class ElasticConfig:
    """Knobs for the self-healing loop (DESIGN.md §7, §12)."""
    topology: HostTopology
    threshold: float = 2.0          # straggler flag at mean + k·std
    patience: int = 3               # sustained outlier steps before flagging
    warmup: int = 5                 # per-monitor warmup (compile steps)
    min_hosts: int = 1              # never evict below this
    max_rebalances: int = 2         # then ride out the degradation
    overlap: float = 0.5            # comm/compute overlap for the search
    search_kw: dict = dataclasses.field(
        # stay in the checkpoint's non-pipelined parameter layout: a live
        # re-plan into a padded pipeline layout would need a migration
        default_factory=lambda: {"max_pp": 1})
    # predicted-vs-measured drift detection (None = off)
    calibration: CalibrationConfig | None = None


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

#: the ticket kinds a rank outside the plan may be handed
ADMIT, FINISHED, ABANDONED = "admit", "finished", "abandoned"
#: a rank outside the plan waits for its ticket in slices of this long,
#: with no deadline: a spare may wait for the whole run.  A run that fails
#: on its members hands it ABANDONED; a member that dies outright takes
#: the job down (``torchrun``'s agent stops every worker).
WAIT_SLICE = timedelta(seconds=30)


def wait_for_key(store, key: str) -> None:
    """Block until ``key`` is set in ``store``, however long that takes:
    wait in slices of :data:`WAIT_SLICE`, and after a slice that ran out
    (``DistStoreError``, or a ``RuntimeError`` from a ``FileStore``) ask
    the store again; a store that can no longer answer raises."""
    while True:
        try:
            store.wait([key], WAIT_SLICE)
            return
        except RuntimeError:
            if store.check([key]):
                return


class ClusterController:
    """Elastic training under cluster-membership churn.

    State machine (``.phase``)::

        RUNNING ──accepted event──▶ DRAINING ──stop+ckpt──▶ REBALANCING
           ▲                                                     │
           └── RESUMING ◀── restore into the re-planned mesh ────┘
        terminal: DONE (n_steps reached) | PREEMPTED (SIGTERM, final ckpt
        committed — a relaunch auto-resumes) | FAILED (retry budget
        exhausted and re-raise, after a final checkpoint)

    One :class:`FaultTolerantLoop` segment runs per plan; per-host step
    times (measured and all-gathered, or synthesized by a
    :class:`~repro_torch.runtime.faults.FaultInjector` on the simulated
    multi-host clock) feed the event sources each step, and any accepted
    event drains the segment — normally with a final synchronous
    checkpoint, or *without* one when the change says the state is
    untrusted (:class:`HostLost`).  Every membership delta then flows
    through :meth:`apply_membership_change`, shrink and grow alike.

    Batches are fetched idempotently per step (a retried step replays the
    *same* batch — the bounded-retry path cannot skip samples), and the
    data stream's content is drawn at global-batch granularity on every
    rank, so the sample stream is invariant across host-count changes in
    either direction.

    It needs the default process group over the launch ranks (``torchrun``
    or ``init_process_group``), whose store outlives any rank
    (:func:`~repro_torch.launch.mesh.launch_world`); ``ckpt``'s writer,
    barrier and gather are set for each plan.
    """

    def __init__(self, model, cfg, optimizer, data: TokenPipeline,
                 ckpt: CheckpointManager, *, elastic: ElasticConfig,
                 batch: int, seq: int, save_every: int = 50,
                 max_retries: int = 3, injector: FaultInjector | None = None,
                 log_every: int = 10, verbose: bool = True):
        self.model = model
        self.cfg = cfg
        self.optimizer = optimizer
        self.data = data
        self.ckpt = ckpt
        self.elastic = elastic
        self.topology = elastic.topology
        # flattened for the elastic search (max_pp=1 default: segment
        # boundaries are irrelevant to a pure DP/TP re-plan)
        self.meta = model.graph(batch, seq).workload_meta()
        self.save_every = save_every
        self.max_retries = max_retries
        self.injector = injector
        self.log_every = log_every
        self.verbose = verbose
        self.machine = MembershipStateMachine()
        self.events: list = []
        self.losses: list = []
        self.calibration = elastic.calibration
        self.profiler = Profiler()
        self.aggregator = HostStragglerAggregator(
            n_hosts=len(self.topology.hosts),
            threshold=elastic.threshold, patience=elastic.patience,
            warmup=elastic.warmup)
        self.aggregator.reset(self.topology.host_ids)
        self.sources: list = [StragglerSource(self.aggregator)]
        self.drift_source = None
        if self.calibration is not None:
            self.drift_source = DriftSource(self.calibration, self.profiler)
            self.sources.append(self.drift_source)
        if injector is not None:
            self.sources.append(InjectorSource(
                injector, default_hw=self.topology.hosts[0].hw))
        self._rebalances = 0
        self._recalibrations = 0
        self._batch_step = -1
        self._batch = None
        self._data_state_before = None
        self.world = None               # the launch world, from run()
        self._generation = 0
        self._tickets: dict = {}        # launch rank → tickets sent to it
        self._stop_at = None            # when the segment was asked to stop
        self._drain_s = 0.0
        self._final_step = None         # from the ticket that ends the run

    @property
    def phase(self) -> str:
        return self.machine.state

    # ------------------------------------------------------------- logging
    def _log(self, msg: str) -> None:
        if self.verbose and dist.is_initialized() and dist.get_rank() == 0:
            print(msg, flush=True)

    def _event(self, kind: str, **kw) -> None:
        self.events.append({"kind": kind, **kw})

    # ------------------------------------------------------------ planning
    def _members(self) -> list:
        """The launch ranks of the current topology, in host order: the
        ranks of the plan's generation, ``[0]`` its rank 0."""
        return self.topology.devices(list(range(self.world.size)))

    def _bind_ckpt(self, plan) -> None:
        """The checkpoint's writer, barrier and gather for ``plan``'s
        generation: its rank 0 writes the whole tree."""
        self.ckpt.rank = dist.get_rank()
        self.ckpt.barrier = dist.barrier
        self.ckpt.gather = ((lambda tree: plan.gather_state(
            tree, self.optimizer)) if plan.sharded else None)

    def _plan_current(self):
        """Search the current cluster and compile the plan + mesh over the
        current generation."""
        plan, cand = plan_for_cluster(
            self.model, self.meta, self.topology.cluster_spec(),
            device_type=self.model.device.type,
            overlap=self.elastic.overlap, search_kw=self.elastic.search_kw)
        self._bind_ckpt(plan)
        return plan, float(cand.total)

    def _predicted_total(self, plan) -> float:
        """The cost model's step-time prediction for the current plan."""
        if plan.placement is not None:
            return float(plan.placement.cost.total)
        g = self.topology.cluster_spec().groups[0]
        return float(step_cost(self.meta, plan.strategy, g.hw,
                               overlap=self.elastic.overlap).total)

    def _group_features(self, plan) -> dict:
        """Per device group: (calibration features, predicted s, hosts).

        The features (``cost_model.step_cost_features`` of the group's
        unit of work) are what the profiler attaches to each measured
        group step time, so ``calibrate.fit`` can invert them back into
        ``Hardware`` rates.
        """
        members = self.topology.group_hosts()
        ov = self.elastic.overlap
        out = {}
        if plan.placement is not None:
            for u in plan.placement.units:
                if u.kind != "group":
                    continue
                out[u.group.name] = (
                    step_cost_features(u.meta, u.strategy, u.group.hw,
                                       overlap=ov),
                    float(u.cost.total), members.get(u.group.name, []))
        else:
            g = self.topology.cluster_spec().groups[0]
            out[g.name] = (
                step_cost_features(self.meta, plan.strategy, g.hw,
                                   overlap=ov),
                float(step_cost(self.meta, plan.strategy, g.hw,
                                overlap=ov).total),
                members.get(g.name, list(self.topology.host_ids)))
        return out

    def _retune_model(self, spec) -> None:
        """The reference's hook that re-autotunes the executing model's
        kernel tiles for ``spec`` after a membership change.  The port's
        kernels fix their tiles when they are compiled
        (:mod:`repro_torch.kernels.autotune`), so the model is left as it
        is; tiles chosen per hardware mix come with the autotuner's port
        (ROADMAP.md queue A item 6)."""

    # ------------------------------------------------- event policy
    def _accept(self, event: ClusterEvent) -> bool:
        """Policy: does this event get to change the fleet?

        The state machine sequences; this gates — budgets, floors, and
        feasibility.  Rejected events are logged and dropped (the fleet
        rides out the condition).
        """
        pending = self.machine.pending
        if isinstance(event, StragglerSustained):
            h = event.host
            self._event("flag", step=event.step, host=h, dt=event.dt,
                        mean=self.aggregator.monitors[h].mean
                        if h in self.aggregator.monitors else None)
            self._log(f"[straggler] host {h} flagged at step {event.step} "
                      f"(dt={event.dt:.3f}s)")
            survivors = (len(self.topology.hosts) - len(pending.evict) - 1)
            if survivors < self.elastic.min_hosts:
                self._log(f"[straggler] NOT evicting host {h}: "
                          f"{survivors} survivors < min_hosts="
                          f"{self.elastic.min_hosts}")
                return False
            if self._rebalances >= self.elastic.max_rebalances:
                self._log("[straggler] rebalance budget exhausted; "
                          "riding out the degradation")
                return False
            return True
        if isinstance(event, DriftSustained):
            if pending.evict:
                return False        # an eviction already drains; its
                                    # rebalance re-plans anyway
            if self._recalibrations >= (self.calibration.max_rebalances
                                        if self.calibration else 0):
                return False
            self._log(f"[drift] measured/predicted skew {event.skew:.2f} "
                      f"sustained {self.calibration.patience} steps at "
                      f"step {event.step}; stopping to recalibrate")
            return True
        if isinstance(event, PreemptionWarning):
            # forced: the scheduler takes the host whether we drain or not
            self._event("preempt_warn", step=event.step, host=event.host,
                        deadline_step=event.deadline_step)
            self._log(f"[preempt-warn] host {event.host} reclaimed by step "
                      f"{event.deadline_step}; draining at step "
                      f"{event.step}")
            return True
        if isinstance(event, HostLost):
            self._event("host_lost", step=event.step, host=event.host)
            self._log(f"[host-lost] host {event.host} vanished at step "
                      f"{event.step} before the drain committed; falling "
                      f"back to the last committed checkpoint")
            return True
        if isinstance(event, HostJoin):
            sh = event.host
            if self._rebalances >= self.elastic.max_rebalances:
                self._log(f"[join] NOT admitting host {sh.host}: rebalance "
                          f"budget exhausted")
                return False
            try:
                grown = self.topology.with_host(sh)
                for admitted in self.machine.pending.admit:
                    grown = grown.with_host(admitted)
                grown.devices(list(range(self.world.size)))
            except ValueError as e:
                self._log(f"[join] NOT admitting host {sh.host}: {e}")
                return False
            self._log(f"[join] host {sh.host} offers {sh.n_devices}×"
                      f"{sh.hw.name} at step {event.step}; draining to "
                      f"grow")
            return True
        raise TypeError(f"not a ClusterEvent: {event!r}")

    def _dispatch(self, event: ClusterEvent,
                  loop: FaultTolerantLoop | None) -> None:
        if not self._accept(event):
            return
        self.machine.on_event(event)
        if loop is not None and self.machine.state == DRAINING:
            if self._stop_at is None:
                self._stop_at = time.monotonic()
            if self.machine.pending.abort:
                loop.request_abort()    # state untrusted: no final save
            else:
                loop.request_stop()     # drain with a final sync ckpt

    # --------------------------------------------- unified membership path
    def apply_membership_change(self, change: MembershipChange, *,
                                at_step: int):
        """THE one path every fleet reshape takes (shrink, grow, re-fit).

        Evictions shrink the topology, admissions grow it, recalibration
        re-fits the hardware tables from profiler observations — then one
        shared tail (:meth:`_replan`): form the next generation of the
        process group, re-plan with the hetero-aware search, restore the
        committed checkpoint into the new plan (for an aborted drain that
        checkpoint predates ``at_step`` — the lost steps replay
        exactly-once), reshard the data stream, reset the monitors.  The
        ranks of admitted hosts are handed the controller's state and join
        the tail there.  Returns ``(step, plan, state)``, or ``None`` on a
        rank whose host left the plan.
        """
        if self.machine.state != REBALANCING:
            raise IllegalTransition(
                f"apply_membership_change outside REBALANCING "
                f"(state {self.machine.state})")
        if change.is_noop:
            raise ValueError("refusing to rebalance on a no-op "
                             "MembershipChange")
        before = self._members()
        hardware = None
        if change.evict:
            for h in change.evict:
                self.aggregator.evict(h)
            self.topology = self.topology.without(set(change.evict))
            self._event("evict", step=at_step, hosts=list(change.evict),
                        surviving_devices=self.topology.n_devices)
            self._log(f"[evict] hosts {list(change.evict)} at step "
                      f"{at_step}; rebalancing onto "
                      f"{self.topology.n_devices} devices")
        if change.admit:
            for sh in change.admit:
                self.topology = self.topology.with_host(sh)
                self.aggregator.admit(sh.host)
            self._event("join", step=at_step,
                        hosts=[sh.host for sh in change.admit],
                        total_devices=self.topology.n_devices)
            self._log(f"[join] hosts {[sh.host for sh in change.admit]} "
                      f"at step {at_step}; rebalancing onto "
                      f"{self.topology.n_devices} devices")
        tune_spec = self.topology.cluster_spec()
        if change.recalibrate and not (change.evict or change.admit):
            # drift-triggered recalibration: same fleet, re-fitted
            # Hardware tables — continuous rebalancing
            tune_spec, hardware = self.profiler.fit_spec(
                self.topology.cluster_spec(),
                last_n=self.calibration.window)
            self._event("drift", step=at_step, skew=change.recalibrate,
                        hardware={
                            n: {"eff_flops": h.peak_flops * h.mxu_eff,
                                "n_obs": h.n_observations}
                            for n, h in hardware.items()})
            self._log(f"[drift] recalibrating at step {at_step} "
                      f"(skew {change.recalibrate:.2f}); re-planning with "
                      f"measured rates")
        self._retune_model(tune_spec)
        kind = "rebalance" if change.evict or change.admit else "recalibrate"
        self._generation += 1
        newcomers = [r for r in self._members() if r not in before]
        if newcomers:
            self._send(newcomers, ADMIT, kind=kind, hardware=hardware)
        return self._replan(kind, hardware)

    def _replan(self, kind: str, hardware):
        """The tail every change shares, on the ranks of the new plan:
        form its generation of the process group, search and compile the
        plan over it and restore the committed checkpoint; ``None`` on a
        rank that is not in the plan (it only leaves its group)."""
        t0 = time.monotonic()
        if not form_generation(self.world, self._generation,
                               self._members()):
            return None
        t1 = time.monotonic()
        ectx = ElasticContext(model=self.model, optimizer=self.optimizer)
        step, plan, params, opt_state, extra = ectx.rebalance(
            self.ckpt, self.topology.cluster_spec(), self.meta,
            device_type=self.model.device.type,
            overlap=self.elastic.overlap,
            search_kw=self.elastic.search_kw,
            hardware=hardware)
        self._bind_ckpt(plan)
        if "data" in extra:
            self.data.load_state_dict(extra["data"])
        self._reshard_data()
        self._batch_step, self._batch = step - 1, None
        state = {"params": params, "opt": opt_state}
        if kind == "rebalance":
            self._rebalances += 1
            self.profiler.clear()   # old groups' names/shares are stale
        else:
            self._recalibrations += 1
        self.aggregator.reset(self.topology.host_ids)
        t2 = time.monotonic()
        self._event(kind, step=step,
                    strategy=plan.strategy.describe(),
                    downtime_s=t2 - t0, drain_s=self._drain_s,
                    regroup_s=t1 - t0, restore_s=t2 - t1,
                    placement=(plan.placement.describe()
                               if plan.placement else None))
        self._log(f"[{kind}] resumed at step {step} with "
                  f"{plan.strategy.describe()}")
        return step, plan, state

    # ------------------------------------- ranks outside the plan (tickets)
    def _send(self, ranks: list, what: str, **kw) -> None:
        """Hand each launch rank of ``ranks`` (waiting outside the plan) a
        ticket: ``what`` and the controller's state, the one every member
        holds.  Every member keeps the count of tickets sent; the current
        generation's rank 0 writes them to the launch store."""
        keys = []
        for r in ranks:
            n = self._tickets.get(r, 0)
            self._tickets[r] = n + 1
            keys.append(f"ticket/{r}/{n}")
        snap = pickle.dumps({
            "what": what, "generation": self._generation,
            "topology": self.topology,
            "machine": (self.machine.state, self.machine.deferred),
            "events": self.events, "losses": self.losses,
            "rebalances": self._rebalances,
            "recalibrations": self._recalibrations,
            "evicted": set(self.aggregator.evicted),
            "tickets": dict(self._tickets),
            "injector": (self.injector.state_dict()
                         if self.injector is not None else None), **kw})
        if dist.get_rank() == 0:
            for key in keys:
                self.world.store.set(key, snap)

    def _wait_outside(self) -> dict:
        """Block, outside every group, until this rank is handed a ticket
        (:meth:`_send`); take the controller's state from it."""
        key = f"ticket/{self.world.rank}/{self._tickets.get(self.world.rank, 0)}"
        wait_for_key(self.world.store, key)
        t = pickle.loads(self.world.store.get(key))
        self._generation = t["generation"]
        self.topology = t["topology"]
        self.machine.state, self.machine.deferred = t["machine"]
        self.events, self.losses = t["events"], t["losses"]
        self._rebalances = t["rebalances"]
        self._recalibrations = t["recalibrations"]
        self.aggregator.evicted = set(t["evicted"])
        self._tickets = t["tickets"]
        if self.injector is not None:
            self.injector.load_state_dict(t["injector"])
        self._final_step = t.get("final_step")
        return t

    def _outside(self):
        """Wait outside the plan until admitted: ``(step, plan, state)``
        from the tail the members run, or ``None`` at the end of the run
        (:data:`FINISHED`); a run that failed raises."""
        t = self._wait_outside()
        if t["what"] == ABANDONED:
            raise RuntimeError(f"the elastic run failed on its members "
                               f"(launch rank {self.world.rank} waited "
                               f"outside the plan)")
        if t["what"] == FINISHED:
            return None
        return self._replan(t["kind"], t["hardware"])

    def _close(self, step) -> int:
        """End of the run: a member (``step`` its final step) releases the
        ranks waiting outside the plan, a released rank takes the final
        step from its ticket; then every launch rank forms one last
        generation over the whole launch world (the group the run took
        over, re-formed).  Returns the final step."""
        if step is not None:
            self._generation += 1
            outside = [r for r in range(self.world.size)
                       if r not in self._members()]
            if outside:
                self._send(outside, FINISHED, final_step=step)
        else:
            step = self._final_step
        form_generation(self.world, self._generation,
                        range(self.world.size))
        return step

    def _reshard_data(self) -> None:
        """Re-slice the data stream onto the new host count (both
        directions).  Content is drawn at global-batch granularity, so
        the global stream is invariant; the port's ranks each draw the
        global batch (1-of-1, as the reference's single-process harness
        does) and need no re-slicing."""
        n_hosts = len(self.topology.hosts)
        if self.data.n_hosts <= 1 or self.data.n_hosts == n_hosts:
            return
        if self.data.cfg.global_batch % n_hosts:
            self._log(f"[reshard] keeping {self.data.n_hosts}-way data "
                      f"sharding: global_batch "
                      f"{self.data.cfg.global_batch} does not divide "
                      f"over {n_hosts} hosts")
            return
        host_id = min(self.data.host_id, n_hosts - 1)
        self.data = self.data.reshard(host_id=host_id, n_hosts=n_hosts)

    # ----------------------------------------------------------- the step
    def _host_times(self, step: int, dt: float) -> dict:
        """host id → this step's time, the same on every rank: the
        injector's nominal clock as it is, else each rank's measured time
        all-gathered (a host's time is the max over its ranks; the
        injector's clock then takes the slowest rank's as its base)."""
        hosts = self.topology.host_ids
        if self.injector is not None and self.injector.nominal is not None:
            return self.injector.host_times(step, base=dt, hosts=hosts)
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, float(dt))
        if self.injector is not None:
            return self.injector.host_times(step, base=max(got), hosts=hosts)
        times: dict = {}
        for r, t in zip(self._members(), got):
            h = self.topology.host_of(r)
            times[h] = max(times.get(h, 0.0), t)
        return times

    def _build_step_fn(self, plan):
        step_fn = plan.train_step_fn(self.optimizer)
        device = self.model.device

        def one_step(i, st):
            if self.injector is not None:
                self.injector.maybe_preempt(i)
            batch = self._batch_for(i)
            if self.injector is not None:
                self.injector.maybe_fail(i)
            local = {k: torch.as_tensor(np.asarray(v)).to(device)
                     for k, v in plan.batch_slice(batch).items()}
            p, o, m = step_fn(st["params"], st["opt"], local, i)
            self.losses.append(float(m["loss"]))
            if i % self.log_every == 0:
                self._log(f"  step {i:5d}  loss {self.losses[-1]:.4f}")
            return {"params": p, "opt": o}

        return one_step

    # -------------------------------------------------- exactly-once data
    def _batch_for(self, step: int) -> dict:
        """Idempotent per-step global batch: a retried step replays the
        same samples instead of silently consuming the next draw."""
        if step != self._batch_step:
            self._data_state_before = self.data.state_dict()
            self._batch = self.data.next_batch()
            self._batch_step = step
        return self._batch

    def _data_state_at(self, step: int) -> dict:
        """The pipeline position with exactly ``step`` batches consumed —
        what a checkpoint committed at ``step`` must record.  A save at
        the *failed* step (retry budget exhausted) lands one batch behind
        the cursor, so the pre-fetch snapshot is returned instead."""
        consumed = self._batch_step + 1
        if step == self._batch_step and self._data_state_before is not None:
            return dict(self._data_state_before)
        if step != consumed:
            raise RuntimeError(
                f"data pipeline out of sync: checkpoint at step {step} but "
                f"{consumed} batches consumed")
        return self.data.state_dict()

    # ------------------------------------------------------------ the loop
    def _start(self, seed: int):
        """Generation 0 on the topology's ranks: the initial plan, its
        state drawn from ``seed`` or resumed from the latest committed
        checkpoint.  Returns ``(step, plan, state)``."""
        form_generation(self.world, self._generation, self._members())
        plan, predicted = self._plan_current()
        self._log(f"[elastic] initial plan: "
                  f"{plan.strategy.describe()} on "
                  f"{self.topology.n_devices} devices "
                  f"(predicted {predicted*1e3:.1f} ms/step)")
        params = plan.init_params(seed)
        state = {"params": params,
                 "opt": plan.init_opt(self.optimizer, params)}
        step = 0
        resume = plan.restore_state(self.ckpt, self.optimizer)
        if resume is not None:
            step, state, extra = resume
            if "data" in extra:
                self.data.load_state_dict(extra["data"])
                self._batch_step, self._batch = step - 1, None
            self._log(f"[resume] from step {step}")
        return step, plan, state

    def _loop(self, n_steps: int, step: int, plan, state) -> tuple:
        """Segments and membership changes until the run ends:
        ``(final step, state)``, or ``(None, None)`` on a rank whose host
        left the plan and that was released from outside at the end."""
        while True:
            # membership signals that arrived while the last change was
            # applying re-enter the machine before the next segment runs
            for ev in self.machine.take_deferred():
                self._dispatch(ev, loop=None)
            if self.machine.state == RUNNING:
                if step >= n_steps:
                    break
                segment_start = step
                if self.drift_source is not None:
                    self.drift_source.rearm(self._group_features(plan),
                                            self._predicted_total(plan))
                loop = FaultTolerantLoop(self.ckpt,
                                         save_every=self.save_every,
                                         max_retries=self.max_retries)

                def on_step(i, st, dt, _loop=loop, _start=segment_start):
                    if i == _start:
                        return      # the first step's warm-up would poison
                                    # the monitors' warmup
                    times = self._host_times(i, dt)
                    for source in self.sources:
                        for ev in source.poll(i, times, self.topology):
                            self._dispatch(ev, loop=_loop)

                step_fn = self._build_step_fn(plan)
                self._stop_at = None
                try:
                    step, state = loop.run(
                        state=state, step_fn=step_fn, n_steps=n_steps,
                        start_step=step,
                        extra_fn=lambda st, s: {"data":
                                                self._data_state_at(s)},
                        on_step=on_step)
                except Exception:
                    self.machine.to(FAILED)
                    raise
                self._drain_s = (0.0 if self._stop_at is None
                                 else time.monotonic() - self._stop_at)
                if loop.preempted:
                    self._event("preempted", step=step,
                                pending_evictions=list(
                                    self.machine.pending.evict))
                    self._log(f"[preempt] SIGTERM at step {step}; final "
                              f"checkpoint committed")
                    self.machine.to(PREEMPTED)
                    break
            if self.machine.state != DRAINING:
                break               # segment completed with nothing pending
            if step >= n_steps and not self.machine.pending.abort:
                # n_steps reached — an event raised on the very last step
                # must not trigger a rebalance whose result is discarded
                # (an abort is the exception: the tail was never
                # committed, so the change must apply and replay it)
                break
            change = self.machine.take()
            self.machine.to(REBALANCING)
            out = self.apply_membership_change(change, at_step=step)
            if out is None:             # this rank's host left the plan
                out = self._outside()
                if out is None:
                    return None, None
            step, plan, state = out
            self.machine.to(RESUMING)
            self.machine.to(RUNNING)
        return step, state

    def run(self, n_steps: int, seed: int = 0) -> dict:
        """Train to ``n_steps`` through every membership change.  Every
        launch rank returns ``{"final_step", "state", "events", "losses",
        "phase", "topology"}``, ``state`` ``None`` on a rank outside the
        final plan, and leaves a process group over the launch world."""
        self.world = launch_world()
        self._members()             # the topology fits the launch world
        step = state = None
        try:
            if self.world.rank in self._members():
                out = self._start(seed)
            else:
                out = self._outside()
                if out is not None:     # admitted: resume as the members
                    self.machine.to(RESUMING)
                    self.machine.to(RUNNING)
            if out is not None:
                step, state = self._loop(n_steps, *out)
        except BaseException:
            if FAILED in _TRANSITIONS[self.phase]:
                self.machine.to(FAILED)
            if dist.is_initialized() and self.world.rank in self._members():
                self._send([r for r in range(self.world.size)
                            if r not in self._members()], ABANDONED)
            raise
        if self.machine.state not in TERMINAL:
            self.machine.to(DONE)
        step = self._close(step)
        return {"final_step": step, "state": state, "events": self.events,
                "losses": self.losses, "phase": self.phase,
                "topology": self.topology}
