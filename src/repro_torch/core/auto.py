"""Automatic parallel-strategy search (paper Case 5 / contributions #3–4):
the port of ``repro/core/auto.py``.

Given a workload's metadata (from an LMCfg through
:func:`repro_torch.models.lm.model_graph` — meta-driven, nothing executes)
and a device budget, enumerate the pruned strategy space and rank by the
cost model:

- **Clustering** (paper: "groups repeatedly occurred sub-structures to prune
  the search space"): for LMCfg workloads the clustering is structural
  (one pattern × n_rep), so the search never scales with depth; for a
  TaskGraph recorded by the annotation scopes each run of identical
  subgraphs becomes one segment (:func:`graph_from_taskgraph`).
- **Pruning**: (dp, tp, pp) only ranges over divisor factorizations of the
  device count; tp is capped at the size of one pod's minor dimension
  (operator sharding across DCN is never competitive); pp over divisors of
  the layer count; micro-batches over powers of two up to batch; pipelined
  points are priced under both schedules (GPipe vs the memory-frugal 1F1B
  — same bubble, different peak activation memory; see
  :mod:`repro_torch.core.schedule`); infeasible (OOM) points are discarded by
  the cost model's memory term.

Returns the ranked candidates so callers can inspect the frontier.  The
default table is :data:`~repro_torch.core.cost_model.H100_SXM`, the card
the port runs on (the reference defaults to its own target, ``TPU_V5E``);
with the same table passed, every result equals the reference's.

**Heterogeneous clusters** (DESIGN.md §2): ``search`` / ``auto_parallel``
accept a :class:`~repro_torch.core.cost_model.ClusterSpec` in place of the
plain device count.  The enumeration is then additionally pruned to
placements that tile every hardware group (no shard straddles a group
boundary), each candidate is balanced by :mod:`repro_torch.core.hetero`
(throughput-proportional batch shares / latency-equalized stage layers),
priced per group with the
slowest group dominating, and discarded if any group's HBM overflows.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core.cost_model import (H100_SXM, ClusterSpec,
                                         CostBreakdown, Hardware, ModelGraph,
                                         SegmentMeta, StrategySpec,
                                         as_workload_meta, step_cost)


def divisors(n: int) -> list:
    out = [d for d in range(1, n + 1) if n % d == 0]
    return out


@dataclasses.dataclass(frozen=True)
class Candidate:
    strategy: StrategySpec
    cost: CostBreakdown
    placement: object = None    # hetero.HeteroPlacement on mixed clusters

    @property
    def total(self) -> float:
        return self.cost.total


def enumerate_strategies(meta, devices, *,
                         max_tp: int = 16, max_pp: int | None = None,
                         micro_options: Iterable | None = None,
                         schedules: Iterable | None = None,
                         ) -> list:
    """Pruned (dp, tp, pp, micro, zero, vocab_split, schedule) enumeration.

    ``devices`` may be a plain count or a :class:`ClusterSpec`; the latter
    adds the group-tiling prune (shards never straddle a hardware group).

    ``meta`` may be a flat :class:`WorkloadMeta` or a segment-aware
    :class:`ModelGraph`.  For multi-segment graphs the pipeline-depth
    prune changes meaning: instead of ``n_layers % pp == 0`` (every layer
    interchangeable), ``pp`` is kept when a *segment-respecting* stage
    partition exists (stage boundaries subdivide one segment or land on
    segment edges; atomic frontends stay whole) — uneven stage sizes are
    the point of the multimodal search, the hetero balancer sizes them.

    ``schedules`` restricts the pipeline-schedule dimension (default both
    ``gpipe`` and ``1f1b`` when pp > 1).  Note the 1F1B activation pricing
    (min(M, S) in-flight) is the *schedule's* bound; the fused SPMD
    engine (the reference's ``core/pipeline.py``) materializes gpipe-order
    memory under autodiff — pass ``schedules=("gpipe",)`` to search for that
    engine's HBM envelope (the executor warns on the mismatch too).
    """
    graph = meta if isinstance(meta, ModelGraph) else None
    if graph is not None and len(graph.segments) == 1:
        graph = None                 # layer-homogeneous: flat rules apply
    meta = as_workload_meta(meta)
    spec = devices if isinstance(devices, ClusterSpec) else None
    if spec is not None:
        from repro_torch.core.hetero import strategy_fits_cluster
        devices = spec.n_devices
    max_pp = max_pp or min(meta.n_layers, 16)
    out = []
    for mp in divisors(devices):     # size of the model mesh axis
        if mp > max_tp:
            continue
        # how the model axis is used: flat operator split (tp), and — for
        # MoE workloads whose expert count it divides — the *nested*
        # replica{split[experts]} hybrid (ep), the paper's §4 nesting
        axis_uses = [{"tp": mp, "ep": 1}]
        if (mp > 1 and meta.n_moe_layers
                and meta.n_experts and meta.n_experts % mp == 0):
            axis_uses.append({"tp": 1, "ep": mp})
        rest = devices // mp
        for pp in divisors(rest):
            if pp > max_pp:
                continue
            if graph is not None:
                if pp > 1 and not graph.feasible_pp(pp):
                    continue
            elif meta.n_layers % pp:
                continue
            dp = rest // pp
            if meta.batch % dp:
                continue
            micros = micro_options or [m for m in (1, 2, 4, 8, 16, 32)
                                       if meta.batch // dp >= m]
            # pipelined points price both schedules: same bubble, but 1F1B
            # buffers min(M, S) in-flight micro-batches vs GPipe's M — the
            # memory term decides which (if either) fits
            scheds = (tuple(schedules) if schedules is not None
                      else ("gpipe", "1f1b")) if pp > 1 else ("gpipe",)
            for use in axis_uses:
                if spec is not None and not strategy_fits_cluster(
                        StrategySpec(dp=dp, pp=pp, **use), spec):
                    continue
                tp = use["tp"]
                for m in (micros if pp > 1 else [1]):
                    for zero in ((0, 1, 3) if dp > 1 else (0,)):
                        for vs in ((True, False) if tp > 1 else (False,)):
                            for of in (False, True):
                                for sched in scheds:
                                    out.append(StrategySpec(
                                        dp=dp, pp=pp, micro_batches=m,
                                        zero=zero, vocab_split=vs,
                                        opt_factored=of, schedule=sched,
                                        **use))
    return out


def search(meta, devices, hw: Hardware = H100_SXM, *,
           top_k: int = 5, overlap: float = 0.5, **enum_kw) -> list:
    """Rank the pruned strategy space by estimated step time.

    Returns the ``top_k`` feasible :class:`Candidate`s, best first.
    ``devices`` may be a :class:`ClusterSpec` (mixed hardware); ``hw`` is
    then ignored and each candidate is balanced + priced per device group
    (candidates carry their :class:`HeteroPlacement`).

    ``meta`` may be a segment-aware :class:`ModelGraph` — pipelined
    candidates then cut stages at segment-respecting boundaries and price
    each stage from its own segments' arithmetic; flat metas price exactly
    as before (byte-identical via the single-segment flattening).
    """
    spec = devices if isinstance(devices, ClusterSpec) else None
    flat = as_workload_meta(meta)
    cands = []
    for strat in enumerate_strategies(meta, devices, **enum_kw):
        if spec is not None:
            from repro_torch.core.hetero import plan_placement
            try:
                pl = plan_placement(meta, strat, spec, overlap=overlap)
            except ValueError:      # no HBM-feasible balance exists
                continue
            if pl.cost.feasible:
                cands.append(Candidate(strategy=strat, cost=pl.cost,
                                       placement=pl))
            continue
        if isinstance(meta, ModelGraph) and len(meta.segments) > 1 \
                and strat.pp > 1:
            # single homogeneous hardware, multi-segment graph: the exact
            # min-max segment-respecting partition under full pricing,
            # slowest stage dominating
            from repro_torch.core.hetero import partition_min_max

            def span_cost(s, lo, hi, _strat=strat):
                return step_cost(meta.stage_meta(lo, hi, _strat.pp),
                                 _strat, hw, overlap=overlap).total

            counts = partition_min_max(meta, strat.pp, span_cost)
            if counts is None:
                continue
            off, worst = 0, None
            for ls in counts:
                c = step_cost(meta.stage_meta(off, off + ls, strat.pp),
                              strat, hw, overlap=overlap)
                off += ls
                if worst is None or c.total > worst.total:
                    worst = c
            if worst is not None and worst.feasible:
                cands.append(Candidate(strategy=strat, cost=worst))
            continue
        c = step_cost(flat, strat, hw, overlap=overlap)
        if c.feasible:
            cands.append(Candidate(strategy=strat, cost=c))
    cands.sort(key=lambda c: c.total)
    return cands[:top_k]


def auto_parallel(meta, devices,
                  hw: Hardware = H100_SXM, **kw) -> StrategySpec:
    """The one-liner of Case 5: pick the best strategy, raise if none fits."""
    best = search(meta, devices, hw, top_k=1, **kw)
    if not best:
        if isinstance(devices, ClusterSpec):
            where = "+".join(f"{g.n_devices}×{g.hw.name}"
                             for g in devices.groups)
        else:
            where = f"{devices}×{hw.name}"
        raise RuntimeError(
            f"no feasible strategy for {as_workload_meta(meta).name} "
            f"on {where}")
    return best[0].strategy


# ---------------------------------------------------------------------------
# TaskGraph path (the scopes API): cluster repeats → segments → ModelGraph
# ---------------------------------------------------------------------------

def graph_from_taskgraph(tg, batch: int, *, name: str = "taskgraph"
                         ) -> ModelGraph:
    """Segment-aware workload summary from recorded Subgraph metadata.

    Clustering: each repeated-substructure group from
    :meth:`TaskGraph.cluster_repeats` becomes ONE segment — (cost of one
    representative) × (group size), the paper's search-space pruning —
    so a traced vision-tower → decoder nest arrives at the planner with
    its segment boundaries intact instead of flattened away.
    """
    segments = []
    for idx, g in enumerate(tg.cluster_repeats()):
        rep = g["nodes"][0]
        k = len(g["nodes"])
        segments.append(SegmentMeta(
            name=f"{rep.name}×{k}" if hasattr(rep, "name") else f"group{idx}",
            n_layers=k,
            fwd_flops=float(rep.flops * k),
            param_bytes=float(rep.param_bytes * k),
            act_bytes_per_layer=float(rep.activation_bytes)))
    if not segments:
        segments = [SegmentMeta(name="empty", n_layers=1, fwd_flops=0.0,
                                param_bytes=0.0, act_bytes_per_layer=0.0)]
    # traced graphs don't distinguish norm/bias params → the flatter 0.95
    # shardable fraction this path has always used
    return ModelGraph(name=name, segments=tuple(segments), batch=batch,
                      tp_shardable_fraction=0.95)
