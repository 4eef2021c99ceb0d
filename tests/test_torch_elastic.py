"""The port's elastic runtime (``repro_torch.runtime.{faults,elastic,
controller}`` and ``launch/train.py --hosts``) against the reference
(``repro.runtime``) on the CPU.

The pure parts are held with ``==``: the fault injector (host times, slow
and drift factors, the crash budget, membership once-only and late
delivery, ``SimClock``) for seeds 0–3, the state machine over every state
pair and event type, ``change_for`` and ``merged``, the topology and the
device lists it deals, the three event sources over the same host times,
and ``search_cluster``'s strategy and placement on the same tables.

End to end, one spawn of 4 gloo ranks (a ``FileStore`` in ``tmp_path``)
runs every scenario through :class:`ClusterController`, each plan on a
generation of the process group of its own: a straggler evicted with a
crash retry, the same for host 0 (the checkpoint's writer moves to the
first survivor), a spot reclaim drained and regrown, a missed deadline
that falls back to the last committed checkpoint, a pure scale-up onto
spare ranks, a drift-triggered recalibration, and SIGTERM → PREEMPTED
with a final checkpoint a relaunch resumes.  Each is held against the
reference: the events against its sources, state machine and policy
replayed over the injector's clock; each step's loss within f32's 2e-5 of
its unmeshed ``loss_fn`` and AdamW loop over the same global stream from
the port's step-0 weights; the consumed stream byte for byte against its
``TokenPipeline``; and every state restored after a change against the
checkpoint it read, bit for bit.  Then the driver under ``torchrun`` on
4 ranks prints the reference CLI test's own lines.
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.core import cost_model as ref_cm
from repro.core.calibrate import refit_spec as ref_refit_spec
from repro.data.pipeline import DataCfg as RefDataCfg
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.models import lm as ref_lm
from repro.optim import optimizer as jax_opt
from repro.runtime import controller as ref_ctl
from repro.runtime import elastic as ref_el
from repro.runtime import faults as ref_faults
from repro.runtime.profiler import Profiler as RefProfiler
from repro.runtime.straggler import HostStragglerAggregator as RefAggregator
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import calibrate, cost_model as cm
from repro_torch.data.pipeline import DataCfg, TokenPipeline
from repro_torch.launch.mesh import leave_group
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro_torch.runtime import controller as ctl
from repro_torch.runtime import elastic as el
from repro_torch.runtime import faults
from repro_torch.runtime.profiler import Profiler
from repro_torch.runtime.straggler import HostStragglerAggregator
from repro_torch.tree import flatten

from torch_harness import TOLS, data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
TOL = TOLS["float32"].fwd
LR = 1e-3
B, T = 8, 32
WORLD = 4
NOMINAL = 0.05

# ---------------------------------------------------------------------------
# the pure parts, held with ==
# ---------------------------------------------------------------------------


def _scenarios(m, seed: int) -> tuple:
    """One of each scenario, placed by ``seed``, built from module ``m``."""
    return (m.SlowHost(host=seed % 3, start_step=2 + seed, factor=3.0 + seed,
                       end_step=None if seed % 2 else 9 + seed),
            m.DriftHost(host=(seed + 1) % 3, start_step=1, end_step=11 + seed,
                        factor=2.5),
            m.CrashStep(step=3 + seed, times=1 + seed % 2),
            m.Preemption(step=7 + seed),
            m.SpotPreemption(host=2, warn_step=4 + seed,
                             deadline_steps=seed % 3),
            m.JoinHost(host=5, step=6 + seed, n_devices=2))


def _injector_trace(m, seed: int, nominal) -> dict:
    """Everything the injector says over steps 0–19 and hosts 0–3: host
    times (measured base 0.1 + step / 100), factors, the crash budget
    (which steps raise, how often), membership signals polled at every
    third step (late delivery) and the clock."""
    inj = m.FaultInjector(scenarios=_scenarios(m, seed), n_hosts=3,
                          seed=seed, nominal=nominal)
    out = {"times": [], "factors": [], "fails": [], "signals": []}
    clock = m.SimClock()
    for step in range(20):
        times = inj.host_times(step, base=0.1 + step / 100)
        out["times"].append(times)
        out["times"].append(inj.host_times(step, hosts=(0, 3)))
        out["factors"].append([inj.slow_factor(step, h) for h in range(4)])
        raised = 0
        while True:
            try:
                inj.maybe_fail(step)
                break
            except RuntimeError as e:
                raised += 1
                out["fails"].append(str(e))
        out["fails"].append(raised)
        if step % 3 == 0:
            out["signals"].append([(k, data(s))
                                   for k, s in inj.membership(step)])
        clock.advance(times)
    clock.charge(1.5)
    out["clock"] = (clock.t, clock.steps)
    out["signals"].append([(k, data(s)) for k, s in inj.membership(100)])
    return out


@pytest.mark.parametrize("seed", range(4))
def test_injector_matches_reference(seed):
    for nominal in (None, NOMINAL):
        assert _injector_trace(faults, seed, nominal) == \
            _injector_trace(ref_faults, seed, nominal)


def test_maybe_preempt_signals_once():
    """``maybe_preempt`` sends SIGTERM to the process itself once per
    scenario, as the reference's."""
    inj = faults.FaultInjector(scenarios=(faults.Preemption(step=2),))
    with mock.patch.object(faults.os, "kill") as kill:
        for step in (1, 2, 2, 3):
            inj.maybe_preempt(step)
    assert kill.call_args_list == [mock.call(os.getpid(),
                                             faults.signal.SIGTERM)]


def _events(m, el_m, cm_m, step=3) -> tuple:
    """One instance of every concrete event type, from module ``m``."""
    return (m.StragglerSustained(step=step, host=1, dt=0.4),
            m.DriftSustained(step=step, skew=1.5),
            m.PreemptionWarning(step=step, host=1, deadline_step=step + 2),
            m.HostLost(step=step, host=1),
            m.HostJoin(step=step, host=el_m.SimHost(7, cm_m.TPU_V5E, 2)))


STATES = ("RUNNING", "DRAINING", "REBALANCING", "RESUMING", "DONE",
          "PREEMPTED", "FAILED")


def _machine_trace(m, el_m, cm_m) -> list:
    """Every ``to`` between state pairs and every event delivered in
    every state: the resulting state, pending change, deferred events,
    and the return value or the error's type and words."""
    out = []
    for a, b in itertools.product(STATES, STATES):
        sm = m.MembershipStateMachine(state=a)
        try:
            sm.to(b)
            out.append(("to", a, b, sm.state))
        except m.IllegalTransition as e:
            out.append(("to", a, b, "illegal", str(e)))
    for state in STATES:
        for ev in _events(m, el_m, cm_m):
            sm = m.MembershipStateMachine(state=state)
            try:
                r = sm.on_event(ev)
                out.append((state, data(ev), r, sm.state, data(sm.pending),
                            data(sm.deferred)))
            except m.IllegalTransition as e:
                out.append((state, data(ev), "illegal", str(e)))
    sm = m.MembershipStateMachine()
    for ev in _events(m, el_m, cm_m):
        sm.on_event(ev)
    out.append(data(sm.take()))
    out.append(data(sm.take()))
    sm.state = "REBALANCING"
    for ev in _events(m, el_m, cm_m):
        sm.on_event(ev)
    out.append((data(sm.take_deferred()), data(sm.take_deferred())))
    return out


def test_state_machine_matches_reference():
    assert _machine_trace(ctl, el, cm) == \
        _machine_trace(ref_ctl, ref_el, ref_cm)
    assert ctl._TRANSITIONS == ref_ctl._TRANSITIONS
    assert ctl.TERMINAL == ref_ctl.TERMINAL


def _changes_trace(m, el_m, cm_m) -> list:
    changes = [m.change_for(ev) for ev in _events(m, el_m, cm_m)]
    changes.append(m.MembershipChange())
    out = [(data(c), c.is_noop) for c in changes]
    for a, b in itertools.product(changes, changes):
        out.append(data(a.merged(b)))
    try:
        m.change_for(m.ClusterEvent(step=1))
    except TypeError as e:
        out.append(str(e))
    return out


def test_change_for_and_merged_match_reference():
    assert _changes_trace(ctl, el, cm) == \
        _changes_trace(ref_ctl, ref_el, ref_cm)


def _topology_trace(el_m, cm_m) -> list:
    out = []
    topo = el_m.HostTopology.uniform(3, 2, cm_m.V100_PAPER)
    flat = list(range(8))
    mixed = el_m.HostTopology(hosts=(el_m.SimHost(0, cm_m.V100_PAPER, 2),
                                     el_m.SimHost(1, cm_m.T4_16G, 2),
                                     el_m.SimHost(2, cm_m.T4_16G, 1),
                                     el_m.SimHost(3, cm_m.V100_PAPER, 1)))
    for t in (topo, mixed, topo.without({1}), topo.without({0, 2}),
              mixed.without({1})):
        out.append((data(t), t.n_devices, t.host_ids, t.devices(flat),
                    t.devices(flat, exclude={0}), data(t.cluster_spec()),
                    t.group_hosts(), [t.host_of(d) for d in t.devices(flat)]))
    grown = topo.without({1})
    for h in (el_m.SimHost(4, cm_m.T4_16G, 2), el_m.SimHost(5, cm_m.T4_16G, 1),
              el_m.SimHost(6, cm_m.V100_PAPER, 3),
              el_m.SimHost(7, cm_m.T4_16G, 1, offset=12)):
        grown = grown.with_host(h)
        out.append((data(grown), grown.devices(list(range(16)))))
    for bad in (el_m.SimHost(0, cm_m.T4_16G, 1), el_m.SimHost(9, cm_m.T4_16G, 0),
                el_m.SimHost(9, cm_m.T4_16G, 1, offset=1)):
        try:
            topo.with_host(bad)
        except ValueError as e:
            out.append(str(e))
    for fn in (lambda: topo.without({0, 1, 2}), lambda: topo.host_of(6),
               lambda: topo.devices(list(range(5)))):
        try:
            fn()
        except ValueError as e:
            out.append(str(e))
    # shrink / grow round trips over the flat device list
    kept = el_m.shrink_devices(flat[:6], {1}, topology=topo)
    back, regrown = el_m.grow_devices(flat[:6], [el_m.SimHost(
        1, cm_m.V100_PAPER, 2)], topology=topo.without({1}))
    out.append((kept, back, data(regrown)))
    devs = [SimpleNamespace(process_index=i // 2) for i in range(6)]
    out.append([d.process_index for d in el_m.shrink_devices(devs, {0, 2})])
    return out


def test_topology_matches_reference():
    assert _topology_trace(el, cm) == _topology_trace(ref_el, ref_cm)
    with pytest.warns(DeprecationWarning):
        el.shrink_devices([0, 1], {0}, host_of=lambda d: d)


def _sources_trace(m, el_m, cm_m, prof_cls, agg_cls) -> list:
    """The three sources over the same host-time sequence: a host slowed
    from step 6, a drift from step 3, a spot notice and a join."""
    topo = el_m.HostTopology.uniform(3, 1, cm_m.TPU_V5E)
    inj = ref_faults if m is ref_ctl else faults
    injector = inj.FaultInjector(scenarios=(
        inj.SlowHost(host=2, start_step=6, factor=4.0),
        inj.DriftHost(host=1, start_step=3, end_step=40, factor=3.0),
        inj.SpotPreemption(host=0, warn_step=9, deadline_steps=1),
        inj.SpotPreemption(host=4, warn_step=2, deadline_steps=0),
        inj.JoinHost(host=3, step=11, n_devices=1),
        inj.JoinHost(host=1, step=5, n_devices=1)), n_hosts=3, seed=2,
        nominal=NOMINAL)
    agg = agg_cls(n_hosts=3, patience=2, warmup=3)
    cal = m.CalibrationConfig(skew=0.05, patience=2, min_steps=3)
    feats = {"g#0": ({"eff_flops": 1e12, "hbm_bw": 1e9}, 0.04, [0, 1, 2])}
    sources = [m.StragglerSource(agg), m.DriftSource(cal, prof_cls()),
               m.InjectorSource(injector, default_hw=cm_m.TPU_V5E)]
    sources[1].rearm(feats, 0.04)
    out = []
    for step in range(20):
        times = injector.host_times(step, hosts=topo.host_ids)
        for s in sources:
            out.append(data(s.poll(step, times, topo)))
    out.append(len(sources[1].profiler.window("g#0")))
    return out


def test_sources_match_reference():
    assert _sources_trace(ctl, el, cm, Profiler, HostStragglerAggregator) \
        == _sources_trace(ref_ctl, ref_el, ref_cm, RefProfiler, RefAggregator)


def _specs(el_m, cm_m) -> dict:
    uni = el_m.HostTopology.uniform(2, 2, cm_m.V100_PAPER)
    G = cm_m.DeviceGroup
    mixed = cm_m.ClusterSpec(groups=(G("v100", cm_m.V100_PAPER, 4),
                                     G("t4", cm_m.T4_16G, 4)))
    return {"uniform_2x2": uni.cluster_spec(),
            "shrink_1x2": uni.without({1}).cluster_spec(),
            "grow_3x2": uni.with_host(el_m.SimHost(
                2, cm_m.V100_PAPER, 2)).cluster_spec(),
            "v100+t4": mixed}


@pytest.mark.parametrize("case", ["uniform_2x2", "shrink_1x2", "grow_3x2",
                                  "v100+t4", "refit"])
def test_search_cluster_matches_reference(case):
    """The winning candidate (strategy, cost, placement) of the same
    cluster in both packages; ``refit`` re-prices the mixed spec with a
    fitted, slower V100 table (``rebalance``'s ``hardware=``)."""
    meta = Model(get_config(ARCH), "meta").graph(64, 512).workload_meta()
    rmeta = ref_lm.build(jax_get_config(ARCH)).graph(64, 512).workload_meta()
    assert data(meta) == data(rmeta)
    key = "v100+t4" if case == "refit" else case
    spec, rspec = _specs(el, cm)[key], _specs(ref_el, ref_cm)[key]
    if case == "refit":
        slow = dataclasses.replace(cm.V100_PAPER, mxu_eff=0.3)
        rslow = dataclasses.replace(ref_cm.V100_PAPER, mxu_eff=0.3)
        spec = calibrate.refit_spec(spec, {"v100": slow})
        rspec = ref_refit_spec(rspec, {"v100": rslow})
    kw = {"max_pp": 1}
    got = el.search_cluster(meta, spec, search_kw=kw)
    want = ref_el.search_cluster(rmeta, rspec, search_kw=kw)
    assert data(got) == data(want)
    big = Model(get_config(ARCH), "meta").graph(1024, 4096).workload_meta()
    with pytest.raises(RuntimeError, match="no feasible strategy for "
                                           "tinyllama-1.1b on 1×t4_16g"):
        el.search_cluster(big, cm.ClusterSpec.homogeneous(cm.T4_16G, 1),
                          search_kw=kw)


# ---------------------------------------------------------------------------
# end to end: the scenarios on 4 gloo ranks
# ---------------------------------------------------------------------------

#: name: (hosts, ranks a host, steps, save every, scenarios as (class name,
#: kwargs), ElasticConfig kwargs, CalibrationConfig kwargs or None)
CASES = {
    "evict": (2, 2, 12, 4, (("SlowHost", dict(host=1, start_step=4,
                                              factor=5.0)),
                            ("CrashStep", dict(step=9, times=1))),
              dict(patience=2, warmup=2), None),
    "evict_host0": (2, 2, 12, 4, (("SlowHost", dict(host=0, start_step=4,
                                                    factor=5.0)),),
                    dict(patience=2, warmup=2), None),
    "spot": (2, 1, 12, 4, (("SpotPreemption", dict(host=1, warn_step=4,
                                                   deadline_steps=2)),
                           ("JoinHost", dict(host=2, step=8, n_devices=1))),
             dict(max_rebalances=4), None),
    "lost": (2, 2, 12, 4, (("SpotPreemption", dict(host=1, warn_step=6,
                                                   deadline_steps=0)),),
             {}, None),
    "scale_up": (1, 2, 12, 4, (("JoinHost", dict(host=1, step=5,
                                                 n_devices=2)),), {}, None),
    "drift": (2, 1, 14, 8, (("DriftHost", dict(host=1, start_step=1,
                                               end_step=101, factor=3.0)),),
              {}, dict(skew=0.08, patience=2)),
    "preempt": (2, 1, 10, 100, (("Preemption", dict(step=5)),), {}, None),
}
#: data seeds per case (different streams)
SEEDS = {name: i for i, name in enumerate(CASES)}


def _build(m, specs) -> tuple:
    return tuple(getattr(m, cls)(**kw) for cls, kw in specs)


class _Recording(TokenPipeline):
    """The global stream, each draw's tokens kept as hex."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def next_batch(self):
        b = super().next_batch()
        self.seen.append(np.asarray(b["tokens"]).tobytes().hex())
        return b


def _controller(name: str, out_dir: str, injector=True):
    hosts, dph, n, save, scen, ekw, ckw = CASES[name]
    cfg = get_config(ARCH, smoke=True)
    data_ = _Recording(DataCfg(global_batch=B, seq_len=T, vocab=cfg.vocab,
                               seed=SEEDS[name]), host_id=0, n_hosts=1)
    inj = (faults.FaultInjector(scenarios=_build(faults, scen), n_hosts=hosts,
                                seed=0, nominal=NOMINAL)
           if injector else None)
    c = ctl.ClusterController(
        Model(cfg, "cpu"), cfg, adamw(lr=LR), data_,
        CheckpointManager(os.path.join(out_dir, name), keep=3),
        elastic=ctl.ElasticConfig(
            topology=el.HostTopology.uniform(hosts, dph, cm.TPU_V5E),
            calibration=ctl.CalibrationConfig(**ckw) if ckw else None,
            **ekw),
        batch=B, seq=T, save_every=save, injector=inj, log_every=100,
        verbose=False)
    rec = {"steps": [], "restored": [], "waits": []}
    real_build, real_replan = c._build_step_fn, c._replan

    def build(plan):
        fn = real_build(plan)

        def one(i, st):
            if name == "scale_up" and i < SPARE_HELD_STEPS:
                time.sleep(SPARE_HELD_S)    # the spares wait for seconds
            out = fn(i, st)
            rec["steps"].append([i, c.losses[-1]])
            return out
        return one

    def replan(kind, hardware):
        """The tail, then the restored state gathered whole on the new
        rank 0 against the checkpoint it read, leaf by leaf, bit for
        bit."""
        out = real_replan(kind, hardware)
        if out is not None:
            step, plan, state = out
            whole = (plan.gather_state(state, c.optimizer) if plan.sharded
                     else state)
            if dist.get_rank() == 0:
                files, _ = c.ckpt.restore(step, whole)
                rec["restored"].append(
                    [step, len(flatten(whole)[1]),
                     all(torch.equal(a, b) for a, b in
                         zip(flatten(whole)[1], flatten(files)[1]))])
        return out

    real_wait = c._wait_outside

    def wait_outside():
        """A wait outside the plan, timed."""
        t0 = time.monotonic()
        out = real_wait()
        rec["waits"].append(time.monotonic() - t0)
        return out

    c._build_step_fn, c._replan = build, replan
    c._wait_outside = wait_outside
    return c, rec


def _run_case(name: str, out_dir: str) -> dict:
    c, rec = _controller(name, out_dir)
    out = c.run(CASES[name][2])
    res = {"events": out["events"], "phase": out["phase"],
           "final_step": out["final_step"],
           "hosts": list(out["topology"].host_ids),
           "losses": out["losses"], "seen": c.data.seen,
           "writer": c.ckpt.rank, **rec}
    if name == "preempt":
        # a relaunch (no injector) resumes the final checkpoint
        c2, rec2 = _controller(name, out_dir, injector=False)
        out2 = c2.run(CASES[name][2])
        res["relaunch"] = {"phase": out2["phase"],
                           "final_step": out2["final_step"],
                           "seen": c2.data.seen, **rec2}
    return res


#: the slice a rank outside the plan waits in, cut so that the waits in
#: the spawn run through several (a ``FileStore`` times out on whole
#: seconds); the scale-up's members take at least SPARE_HELD_S a step
#: before the join, so its spares wait for seconds
WAIT_SLICE = timedelta(milliseconds=50)
SPARE_HELD_STEPS, SPARE_HELD_S = 5, 0.5


def _rank_main(rank: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    ctl.WAIT_SLICE = WAIT_SLICE
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    res = {name: _run_case(name, out_dir) for name in CASES}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    leave_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("elastic")
    ctx = mp.start_processes(_rank_main, args=(str(d / "store"), str(d)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + 180
    for p in ctx.processes:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in ctx.processes if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank did not finish within 180 s"
    assert ctx.join(), "the ranks did not exit"
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


class _Replay(ref_ctl.ClusterController):
    """The reference's controller without a model, a mesh or a
    checkpoint: its sources, state machine and policy (``_accept``,
    ``_dispatch``, ``_group_features``) fed the injector's nominal clock,
    the segment loop of ``run`` with ``FaultTolerantLoop``'s save points,
    and the topology half of ``apply_membership_change``; a change
    restores the last committed step."""

    def __init__(self, name: str):
        hosts, dph, n, save, scen, ekw, ckw = CASES[name]
        self.n_steps, self.save_every = n, save
        self.injector = ref_faults.FaultInjector(
            scenarios=_build(ref_faults, scen), n_hosts=hosts, seed=0,
            nominal=NOMINAL)
        self.elastic = ref_ctl.ElasticConfig(
            topology=ref_el.HostTopology.uniform(hosts, dph, ref_cm.TPU_V5E),
            calibration=ref_ctl.CalibrationConfig(**ckw) if ckw else None,
            **ekw)
        self.topology = self.elastic.topology
        self.meta = ref_lm.build(jax_get_config(ARCH, smoke=True)).graph(
            B, T).workload_meta()
        self.verbose = False
        self.machine = ref_ctl.MembershipStateMachine()
        self.events = []
        self.calibration = self.elastic.calibration
        self.profiler = RefProfiler()
        self.aggregator = RefAggregator(
            n_hosts=hosts, threshold=self.elastic.threshold,
            patience=self.elastic.patience, warmup=self.elastic.warmup)
        self.aggregator.reset(self.topology.host_ids)
        self.sources = [ref_ctl.StragglerSource(self.aggregator)]
        self.drift_source = None
        if self.calibration is not None:
            self.drift_source = ref_ctl.DriftSource(self.calibration,
                                                    self.profiler)
            self.sources.append(self.drift_source)
        self.sources.append(ref_ctl.InjectorSource(
            self.injector, default_hw=self.topology.hosts[0].hw))
        self._rebalances = self._recalibrations = 0

    def _plan(self, hardware=None):
        spec = self.topology.cluster_spec()
        if hardware:
            spec = ref_refit_spec(spec, hardware)
        cand = ref_el.search_cluster(self.meta, spec,
                                     overlap=self.elastic.overlap,
                                     search_kw=self.elastic.search_kw)
        return SimpleNamespace(strategy=cand.strategy, placement=(
            None if spec.is_homogeneous else cand.placement))

    def replay(self) -> list:
        """[(step, kind) of every step the segments ran] and the events;
        ``jax.devices()`` (a join's feasibility check) is the launch
        world's ranks."""
        with mock.patch.object(ref_ctl.jax, "devices",
                               lambda: list(range(WORLD))):
            return self._replay()

    def _replay(self):
        m, steps = self.machine, []
        step, committed, plan = 0, None, self._plan()
        preempt_at = {s.step for s in self.injector.scenarios
                      if isinstance(s, ref_faults.Preemption)}
        while True:
            for ev in m.take_deferred():
                self._dispatch(ev, loop=None)
            if m.state == ref_ctl.RUNNING:
                if step >= self.n_steps:
                    break
                start = step
                if self.drift_source is not None:
                    self.drift_source.rearm(self._group_features(plan),
                                            self._predicted_total(plan))
                loop = SimpleNamespace(stop=False, abort=False)
                loop.request_stop = lambda _l=loop: setattr(_l, "stop", True)
                loop.request_abort = lambda _l=loop: setattr(_l, "abort",
                                                             True)
                term = False
                while step < self.n_steps:
                    term = term or step in preempt_at
                    while True:                 # the bounded retry
                        try:
                            self.injector.maybe_fail(step)
                            break
                        except RuntimeError:
                            pass
                    steps.append(step)
                    if step != start:
                        times = self.injector.host_times(
                            step, hosts=self.topology.host_ids)
                        for s in self.sources:
                            for ev in s.poll(step, times, self.topology):
                                self._dispatch(ev, loop=loop)
                    step += 1
                    if loop.abort:
                        break
                    if step % self.save_every == 0:
                        committed = step
                    if term or loop.stop:
                        committed = step
                        break
                else:
                    committed = step
                if term:
                    self._event("preempted", step=step,
                                pending_evictions=list(m.pending.evict))
                    m.to(ref_ctl.PREEMPTED)
                    break
            if m.state != ref_ctl.DRAINING:
                break
            if step >= self.n_steps and not m.pending.abort:
                break
            change = m.take()
            m.to(ref_ctl.REBALANCING)
            hardware = self._apply(change, step)
            step = committed
            plan = self._plan(hardware)
            if change.evict or change.admit:
                kind = "rebalance"
                self._rebalances += 1
                self.profiler.clear()
            else:
                kind = "recalibrate"
                self._recalibrations += 1
            self.aggregator.reset(self.topology.host_ids)
            self._event(kind, step=step)
            m.to(ref_ctl.RESUMING)
            m.to(ref_ctl.RUNNING)
        if m.state not in ref_ctl.TERMINAL:
            m.to(ref_ctl.DONE)
        return steps, step

    def _apply(self, change, at_step):
        """The reference's ``apply_membership_change`` up to its re-plan
        (the events and the topology); the fitted tables of a
        recalibration."""
        if change.evict:
            for h in change.evict:
                self.aggregator.evict(h)
            self.topology = self.topology.without(set(change.evict))
            self._event("evict", step=at_step, hosts=list(change.evict),
                        surviving_devices=self.topology.n_devices)
        if change.admit:
            for sh in change.admit:
                self.topology = self.topology.with_host(sh)
                self.aggregator.admit(sh.host)
            self._event("join", step=at_step,
                        hosts=[sh.host for sh in change.admit],
                        total_devices=self.topology.n_devices)
        if change.recalibrate and not (change.evict or change.admit):
            _, hardware = self.profiler.fit_spec(
                self.topology.cluster_spec(), last_n=self.calibration.window)
            self._event("drift", step=at_step, skew=change.recalibrate)
            return hardware
        return None


KEYS = ("kind", "step", "host", "hosts", "deadline_step", "surviving_devices",
        "total_devices", "skew")


def _proj(events) -> list:
    """An event list without its timings, strategies and fitted numbers."""
    return [{k: e[k] for k in KEYS if k in e} for e in events]


@pytest.fixture(scope="module")
def ref_runs():
    """Per case: the reference's replayed events and executed steps, and
    its unmeshed loss_fn + AdamW losses over the same global stream from
    the port's step-0 weights."""
    cfg = get_config(ARCH, smoke=True)
    jm = ref_lm.build(jax_get_config(ARCH, smoke=True))
    template = jm.init(jax.random.key(0))
    paths = _leaf_paths(template)
    w0 = dict(zip(*flatten(Model(cfg, "cpu").init(0))))
    params0 = jax.tree.unflatten(
        jax.tree.structure(template),
        [jnp.asarray(w0[p].numpy()) for p in paths])
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    out = {}
    for name, (_, _, n, *_rest) in CASES.items():
        replay = _Replay(name)
        steps, final = replay.replay()
        stream = RefTokenPipeline(RefDataCfg(global_batch=B, seq_len=T,
                                             vocab=cfg.vocab,
                                             seed=SEEDS[name]))
        batches = [stream.next_batch()["tokens"] for _ in range(n)]
        opt = jax_opt.adamw(lr=LR)
        p, st, losses = params0, opt.init(params0), []
        for i in range(n):
            (loss, _), g = grad_fn(p, {"tokens": jnp.asarray(batches[i])})
            p, st = opt.apply(g, st, p, i)
            losses.append(float(loss))
        out[name] = {"events": _proj(replay.events), "steps": steps,
                     "final": final, "phase": replay.machine.state,
                     "hosts": list(replay.topology.host_ids),
                     "stream": [b.tobytes().hex() for b in batches],
                     "losses": losses}
    return out


def _member_throughout(name: str) -> int:
    """A launch rank in every plan of the case."""
    return 2 if name == "evict_host0" else 0


@pytest.mark.parametrize("name", list(CASES))
def test_events_match_reference_replay(name, ranks, ref_runs):
    """Every launch rank reports the reference's events (kinds, steps,
    hosts), phase, final step and surviving hosts."""
    want = ref_runs[name]
    for r, res in enumerate(ranks):
        got = res[name]
        assert _proj(got["events"]) == want["events"], (r, got["events"])
        assert (got["phase"], got["final_step"], got["hosts"]) == \
            (want["phase"], want["final"], want["hosts"]), r


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_reference_adamw(name, ranks, ref_runs):
    """Each executed step's loss (replays included) within f32's 2e-5 of
    the reference's unmeshed loss_fn + AdamW at that step; the steps run
    are the replay's; every rank ends with the same loss history."""
    want = ref_runs[name]
    got = ranks[_member_throughout(name)][name]["steps"]
    assert [s for s, _ in got] == want["steps"]
    np.testing.assert_allclose([v for _, v in got],
                               [want["losses"][s] for s, _ in got],
                               rtol=TOL, atol=TOL)
    assert all(res[name]["losses"] == ranks[0][name]["losses"]
               for res in ranks)


@pytest.mark.parametrize("name", list(CASES))
def test_stream_is_exactly_once(name, ranks, ref_runs):
    """The consumed stream is the reference's ``TokenPipeline``'s, byte
    for byte: no repeats and no skips across a crash retry and every
    drain; a missed deadline replays from the last committed step."""
    want = ref_runs[name]["stream"]
    seen = ranks[_member_throughout(name)][name]["seen"]
    n = CASES[name][2]
    if name == "lost":
        lost = next(e["step"] for e in ref_runs[name]["events"]
                    if e["kind"] == "host_lost")
        save = CASES[name][3]
        assert seen == want[:lost + 1] + want[save:]
    elif name == "preempt":
        relaunch = ranks[0][name]["relaunch"]
        assert seen == want[:6]
        assert relaunch["seen"] == want[6:]
        assert (relaunch["phase"], relaunch["final_step"]) == ("DONE", n)
    else:
        assert seen == want[:n]


@pytest.mark.parametrize("name", [n for n in CASES if n != "preempt"])
def test_restores_equal_their_checkpoint(name, ranks, ref_runs):
    """After every change the new rank 0 holds the checkpoint it read,
    leaf by leaf, bit for bit; evicting host 0 moves the writer to the
    first survivor (launch rank 2)."""
    restores = [r for res in ranks for r in res[name]["restored"]]
    changes = [e for e in ref_runs[name]["events"]
               if e["kind"] in ("rebalance", "recalibrate")]
    assert sorted(s for s, _, _ in restores) == \
        sorted(e["step"] for e in changes)
    assert all(ok and n > 0 for _, n, ok in restores), restores
    if name == "evict_host0":
        assert ranks[2][name]["writer"] == 0 and ranks[2][name]["restored"]


def test_spares_wait_past_their_slice_and_are_admitted(ranks):
    """A rank outside the plan waits with no deadline: the scale-up's
    spares (launch ranks 2 and 3) wait through slices of
    :data:`WAIT_SLICE` that run out (two at least: the ``FileStore``
    rounds a slice up to a second) and are still admitted, and train to
    the end."""
    n = CASES["scale_up"][2]
    for r in (2, 3):
        got = ranks[r]["scale_up"]
        assert got["waits"] and got["waits"][0] > 2.0, (r, got["waits"])
        assert got["steps"] and got["steps"][-1][0] == n - 1, r
        assert got["final_step"] == n


@pytest.mark.parametrize("kind", ["hash", "file", "tcp"])
def test_wait_for_key_has_no_deadline(kind, tmp_path, monkeypatch):
    """``wait_for_key`` outlasts any number of slices that run out, on
    each kind of store a launch world has (a ``FileStore`` times out with
    a plain ``RuntimeError``, the others with ``DistStoreError``), and
    returns once the key is set."""
    import threading
    monkeypatch.setattr(ctl, "WAIT_SLICE", timedelta(milliseconds=100))
    if kind == "hash":
        store = dist.HashStore()
    elif kind == "file":
        store = dist.FileStore(str(tmp_path / "store"), 1)
    else:
        store = dist.PrefixStore("gen0", dist.TCPStore(
            "127.0.0.1", 0, 1, is_master=True, wait_for_workers=False))
    delay = 2.5 if kind == "file" else 1.0
    timer = threading.Timer(delay, lambda: store.set("ticket/2/0", "x"))
    timer.start()
    t0 = time.monotonic()
    try:
        ctl.wait_for_key(store, "ticket/2/0")
    finally:
        timer.cancel()
    assert time.monotonic() - t0 >= delay - 0.05
    assert store.get("ticket/2/0") == b"x"


# ---------------------------------------------------------------------------
# the driver under torchrun
# ---------------------------------------------------------------------------

def test_train_driver_hosts_evicts_and_rebalances(tmp_path):
    """The reference CLI test's command (tests/test_drivers.py) on 4 CPU
    ranks: host 1 is evicted, the job rebalances onto host 0 and ends
    DONE, with the reference's lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", "--steps", "12", "--batch", "8",
         "--seq", "64", "--hosts", "2", "--inject-slow", "1:4:5",
         "--straggler-warmup", "2", "--patience", "2", "--save-every", "4",
         "--log-every", "4", "--ckpt-dir", str(tmp_path / "ck"),
         "--overrides", "n_layers=2"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    out = p.stdout
    assert "[evict] hosts [1]" in out
    assert "[rebalance] resumed" in out
    assert "phase DONE, 1 eviction(s)" in out
    assert out.count("[done]") == 1            # rank 0 alone prints
