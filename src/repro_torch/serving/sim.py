"""Analytic discrete-event serving simulator: colocated-dense vs
disaggregated-paged.  The port of ``repro/serving/sim.py``: pure Python
over the ported cost model, ``metrics`` and ``traffic``, with no tensors,
equal to the reference's with ``==`` (tests/test_torch_serving_sim.py).

The same open-loop Pareto trace (:mod:`repro_torch.serving.traffic`) is
played against two deployments of the same model on the same cluster,
with step times from the serving cost model
(:mod:`repro_torch.core.cost_model`); nothing runs on a device:

- **colocated dense** (the plain server): every device group runs
  prefill *and* decode; each admitted slot reserves ``max_len`` KV rows,
  and every decode step *reads* the full reservation (``active ×
  max_len`` context tokens); a prefill blocks the group's decode batch
  head-of-line.
- **disaggregated paged**: :func:`repro_torch.serving.router.route`
  splits the groups into a prefill pool and a decode pool; prompts
  prefill FIFO on the compute-rich pool, the KV crosses the slow link
  (:func:`~repro_torch.core.cost_model.kv_handoff_time`), and the decode
  pool runs a paged cache — admission is gated on the page budget
  (:func:`~repro_torch.core.cost_model.serving_page_budget`) and a step
  reads only the tokens actually cached.

Both arms are work-conserving and use the identical per-request
:class:`~repro_torch.serving.metrics.RequestTiming` accounting; TTFT in
both is arrival → end of the prefill that produces token 1.  Requests are
dispatched to parallel groups/pools statically (weighted least-loaded),
which keeps the event loops per-group and deterministic.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.core.cost_model import (ClusterSpec, ServingMeta,
                                         decode_step_time, prefill_time,
                                         serving_page_budget)
from repro_torch.serving.metrics import RequestTiming, ServeMetrics
from repro_torch.serving.router import DisaggPlan, route
from repro_torch.serving.traffic import Arrival, TrafficCfg, make_trace


@dataclasses.dataclass(frozen=True)
class ServeScenario:
    """One cluster + model + traffic shape to play both arms over."""
    name: str
    spec: ClusterSpec
    traffic: TrafficCfg
    batch_slots: int = 16
    page_size: int = 64
    max_len: int = 2048          # dense arm's per-slot reservation
    seed: int = 0


@dataclasses.dataclass
class _Live:
    """One request mid-decode inside a group loop."""
    tm: RequestTiming
    left: int                    # decode tokens still to emit
    ctx: int                     # KV rows actually cached (paged reads this)
    pages: int = 0               # pages held (paged arm bookkeeping)


def _dispatch(arrivals, groups, weight) -> dict:
    """Static weighted least-loaded assignment of requests to groups.

    Deterministic stand-in for a load balancer: each request goes to the
    group minimising (assigned work / weight).  Returns {group.name: [..]}.
    """
    load = {g.name: 0.0 for g in groups}
    w = {g.name: max(weight(g), 1e-30) for g in groups}
    out = {g.name: [] for g in groups}
    for a in arrivals:
        gname = min(load, key=lambda n: (load[n] / w[n], n))
        out[gname].append(a)
        load[gname] += a.prompt_len + a.gen_len
    return out


# ---------------------------------------------------------------------------
# arm 1: colocated dense
# ---------------------------------------------------------------------------

def _colocated_group(meta: ServingMeta, g, arrivals, *, batch_slots: int,
                     max_len: int) -> list:
    """One group serving prefill+decode with a dense max_len-per-slot cache."""
    t = 0.0
    queue = deque(arrivals)
    active: list = []
    out = []
    while queue or active:
        if queue and len(active) < batch_slots and queue[0].t <= t:
            # prefill blocks the whole group (the colocated pathology)
            a = queue.popleft()
            tm = RequestTiming(rid=a.rid, arrival=a.t, admitted=t)
            t += prefill_time(meta, g, a.prompt_len)
            tm.first_token = t
            tm.n_tokens = 1
            if a.gen_len <= 1:
                tm.finished = t
                out.append(tm)
            else:
                active.append(_Live(tm=tm, left=a.gen_len - 1,
                                    ctx=a.prompt_len + 1))
            continue
        if active:
            # dense decode reads every slot's FULL reservation
            t += decode_step_time(meta, g, len(active),
                                  len(active) * max_len)
            finished = []
            for r in active:
                r.tm.n_tokens += 1
                r.left -= 1
                r.ctx += 1
                if r.left == 0:
                    r.tm.finished = t
                    finished.append(r)
            for r in finished:
                active.remove(r)
                out.append(r.tm)
            continue
        t = max(t, queue[0].t)       # idle: jump to the next arrival
    return out


def simulate_colocated(meta: ServingMeta, sc: ServeScenario) -> dict:
    """Every group runs the dense colocated server; merged metrics."""
    trace = make_trace(sc.traffic, seed=sc.seed)
    assignment = _dispatch(trace, sc.spec.groups, lambda g: g.group_flops)
    metrics = ServeMetrics()
    for g in sc.spec.groups:
        for tm in _colocated_group(meta, g, assignment[g.name],
                                   batch_slots=sc.batch_slots,
                                   max_len=sc.max_len):
            metrics.add(tm)
    return metrics.summary()


# ---------------------------------------------------------------------------
# arm 2: disaggregated prefill/decode + paged decode cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Handoff:
    """A prefilled request en route to the decode pool."""
    arrival: Arrival
    tm: RequestTiming
    ready_t: float               # prefill end + KV handoff


def _prefill_pool(meta: ServingMeta, groups, arrivals,
                  handoff_s: float) -> tuple:
    """FIFO multi-server prefill queue; emits token 1 of every request.

    Returns (finished_timings, handoffs) — gen_len<=1 requests finish at
    prefill and never cross to the decode pool.
    """
    clocks = {g.name: 0.0 for g in groups}
    by_name = {g.name: g for g in groups}
    done, handoffs = [], []
    for a in arrivals:               # FIFO: arrival order
        gname = min(clocks, key=lambda n: (max(clocks[n], a.t), n))
        g = by_name[gname]
        start = max(clocks[gname], a.t)
        end = start + prefill_time(meta, g, a.prompt_len)
        clocks[gname] = end
        tm = RequestTiming(rid=a.rid, arrival=a.t, admitted=start,
                           first_token=end, n_tokens=1)
        if a.gen_len <= 1:
            tm.finished = end
            done.append(tm)
        else:
            handoffs.append(_Handoff(arrival=a, tm=tm,
                                     ready_t=end + handoff_s))
    handoffs.sort(key=lambda h: (h.ready_t, h.arrival.rid))
    return done, handoffs


def _paged_decode_group(meta: ServingMeta, g, items, *, batch_slots: int,
                        page_size: int, reserve: float = 0.2) -> list:
    """One decode group over a paged cache with page-budget admission."""
    budget = serving_page_budget(meta, g, page_size, reserve=reserve)
    pending = deque(items)
    free = budget
    t = 0.0
    active: list = []
    out = []

    def pages_for(n):
        return -(-n // page_size)

    while pending or active:
        if pending and len(active) < batch_slots:
            h = pending[0]
            need = pages_for(h.arrival.prompt_len + h.arrival.gen_len)
            if need > budget:
                raise ValueError(
                    f"request {h.arrival.rid} needs {need} pages but group "
                    f"{g.name}'s whole budget is {budget} — it can never "
                    f"be admitted")
            if h.ready_t <= t and need <= free:
                pending.popleft()
                free -= need
                active.append(_Live(tm=h.tm, left=h.arrival.gen_len - 1,
                                    ctx=h.arrival.prompt_len + 1,
                                    pages=need))
                continue
        if active:
            # paged decode reads only the tokens actually cached
            ctx = sum(r.ctx for r in active)
            t += decode_step_time(meta, g, len(active), ctx)
            finished = []
            for r in active:
                r.tm.n_tokens += 1
                r.left -= 1
                r.ctx += 1
                if r.left == 0:
                    r.tm.finished = t
                    finished.append(r)
            for r in finished:
                active.remove(r)
                free += r.pages
                out.append(r.tm)
            continue
        t = max(t, pending[0].ready_t)   # idle: wait for the next handoff
    return out


def simulate_disagg(meta: ServingMeta, sc: ServeScenario,
                    plan: DisaggPlan | None = None) -> tuple:
    """Disaggregated + paged arm.  Returns (summary, plan)."""
    if plan is None:
        mean_prompt = int(sum(sc.traffic.prompt_lens)
                          / len(sc.traffic.prompt_lens))
        mean_gen = int(sum(sc.traffic.gen_lens) / len(sc.traffic.gen_lens))
        plan = route(meta, sc.spec, mean_prompt=mean_prompt,
                     mean_gen=mean_gen, page_size=sc.page_size,
                     batch_slots=sc.batch_slots)
    trace = make_trace(sc.traffic, seed=sc.seed)
    metrics = ServeMetrics()
    done, handoffs = _prefill_pool(meta, plan.prefill.groups, trace,
                                   plan.handoff_s)
    for tm in done:
        metrics.add(tm)
    # decode-pool dispatch weighted by memory bandwidth (what decode buys)
    by_group = _dispatch(
        [h.arrival for h in handoffs], plan.decode.groups,
        lambda g: g.n_devices * g.hw.hbm_bw)
    by_rid = {h.arrival.rid: h for h in handoffs}
    for g in plan.decode.groups:
        items = sorted((by_rid[a.rid] for a in by_group[g.name]),
                       key=lambda h: (h.ready_t, h.arrival.rid))
        for tm in _paged_decode_group(meta, g, items,
                                      batch_slots=sc.batch_slots,
                                      page_size=sc.page_size):
            metrics.add(tm)
    return metrics.summary(), plan


def compare(meta: ServingMeta, sc: ServeScenario) -> dict:
    """Both arms on one scenario + the headline ratios fig_serve gates."""
    base = simulate_colocated(meta, sc)
    ours, plan = simulate_disagg(meta, sc)
    return {
        "scenario": sc.name,
        "colocated": base,
        "disagg": ours,
        "plan": plan.describe(),
        "tokens_per_s_ratio": ours["tokens_per_s"]
        / max(base["tokens_per_s"], 1e-12),
        "ttft_p99_ratio": ours["ttft_p99_s"] / max(base["ttft_p99_s"], 1e-12),
    }
