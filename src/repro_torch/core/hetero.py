"""Hardware-aware balancing over heterogeneous device groups (Whale §5):
the port of ``repro/core/hetero.py``.

The paper's headline mechanism: when a cluster mixes GPU generations
(V100 pods next to P100/T4 pods), an even split of work makes every step
wait for the slowest card.  Whale restores balance with two mechanisms,
both implemented here against the meta-driven cost model (DESIGN.md §2):

1. **Intra-stage batch balancing** (:func:`balance_batch`): replicas of
   the same (sub)graph placed on different hardware receive micro-batch
   shares proportional to their group's *effective* FLOP/s
   (peak × achievable efficiency), subject to each group's HBM cap.  The
   shares always sum to the global batch.
2. **Inter-stage layer balancing** (:func:`balance_stages`): pipeline
   stages hosted on unequal devices are sized so per-stage latency
   equalizes — layers allocated ∝ stage FLOP/s, repaired against each
   stage's memory budget.

:func:`plan_placement` combines the two into a :class:`HeteroPlacement`
and :func:`hetero_step_cost` evaluates the four-term step cost *per
group* with the slowest group dominating (a synchronous step can go no
faster than its stragglers).  Every function reduces **exactly** to the
homogeneous behaviour on a single-group / uniform :class:`ClusterSpec` —
the reference's tests/test_heterogeneous.py guards this byte-for-byte, and
tests/test_torch_planning.py holds every function here equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.cost_model import (ClusterSpec, CostBreakdown,
                                         DeviceGroup, ModelGraph,
                                         StrategySpec, WorkloadMeta,
                                         all_reduce_time, as_workload_meta,
                                         step_cost)


# ---------------------------------------------------------------------------
# integer proportional allocation (largest-remainder)
# ---------------------------------------------------------------------------


def proportional_split(total: int, weights: Sequence[float], *,
                       minimum: int = 0) -> list:
    """Split ``total`` integer units ∝ ``weights`` (largest-remainder).

    Guarantees ``sum(out) == total`` and ``out[i] >= minimum``; equal
    weights with a divisible total produce an exactly even split (the
    homogeneous-reduction requirement).
    """
    n = len(weights)
    if total < minimum * n:
        raise ValueError(f"cannot give {n} parts ≥{minimum} from {total}")
    spare = total - minimum * n
    wsum = sum(weights)
    if wsum <= 0:
        weights = [1.0] * n
        wsum = float(n)
    ideal = [spare * w / wsum for w in weights]
    out = [int(math.floor(x)) for x in ideal]
    rem = spare - sum(out)
    # hand the leftover units to the largest fractional parts (stable order)
    order = sorted(range(n), key=lambda i: (ideal[i] - out[i], -i),
                   reverse=True)
    for i in order[:rem]:
        out[i] += 1
    return [minimum + x for x in out]


# ---------------------------------------------------------------------------
# meta re-scaling: view the workload through one group's / stage's share
# ---------------------------------------------------------------------------


def scale_meta_batch(meta: WorkloadMeta, batch: int) -> WorkloadMeta:
    """The workload as seen by a replica group that owns ``batch`` samples.

    FLOPs, activations, and logits scale with the batch share; parameters
    are fully replicated into every DP group, so they do not.
    """
    f = batch / meta.batch if meta.batch else 0.0
    return dataclasses.replace(
        meta, fwd_flops=meta.fwd_flops * f,
        act_bytes_per_layer=meta.act_bytes_per_layer * f,
        logits_bytes=meta.logits_bytes * f, batch=batch)


def scale_meta_stage(meta: WorkloadMeta, layers: int, pp: int) -> WorkloadMeta:
    """The workload as seen by ONE pipeline stage holding ``layers`` layers.

    ``step_cost`` divides compute/params by ``pp`` internally, so the
    per-stage view multiplies the stage's layer share back by ``pp``:
    a stage holding L_s of L layers sees ``fwd_flops · (L_s/L) · pp`` so
    that its share after the internal ``/pp`` is exactly ``L_s/L``.  With
    the even split ``L_s = L/pp`` this is the identity — the homogeneous
    reduction is byte-exact.
    """
    f = layers / meta.n_layers
    return dataclasses.replace(
        meta,
        fwd_flops=meta.fwd_flops * f * pp,
        param_bytes=meta.param_bytes * f * pp,
        tp_shardable_param_bytes=meta.tp_shardable_param_bytes * f * pp,
        n_layers=layers * pp)


# ---------------------------------------------------------------------------
# strategy ↔ cluster compatibility
# ---------------------------------------------------------------------------


def strategy_fits_cluster(strat: StrategySpec, spec: ClusterSpec) -> bool:
    """Can ``strat`` be laid out on ``spec`` without splitting a shard
    across a hardware boundary?

    - ``pp == 1``: each group hosts whole replicas → ``tp·pp`` must divide
      every group's device count.
    - ``pp > 1``: each group hosts whole stages → ``dp·tp`` (one stage's
      devices) must divide every group's device count.
    """
    if strat.devices != spec.n_devices:
        return False
    mp = strat.model_parallel
    unit = mp * strat.pp if strat.pp == 1 else strat.dp * mp
    return all(g.n_devices % unit == 0 for g in spec.groups)


def shrink_cluster(spec: ClusterSpec, removed: dict) -> ClusterSpec:
    """The surviving cluster after eviction: ``removed`` maps group name →
    number of devices leaving that group (a flagged host's devices).

    This is the group-keyed counterpart of
    ``runtime.elastic.HostTopology.without`` for deployments that track a
    plain :class:`ClusterSpec` (real multi-process fleets keyed by
    ``process_index``) rather than the simulated host topology.

    Groups that lose all their devices are dropped; removing more devices
    than a group has, or naming an unknown group, is a loud error — the
    eviction machinery must never silently shrink the wrong pool.
    """
    by_name = {g.name: g for g in spec.groups}
    for name, k in removed.items():
        if name not in by_name:
            raise ValueError(f"unknown device group {name!r}; have "
                             f"{sorted(by_name)}")
        if k > by_name[name].n_devices:
            raise ValueError(
                f"cannot remove {k} devices from group {name!r} "
                f"({by_name[name].n_devices} present)")
    groups = []
    for g in spec.groups:
        n = g.n_devices - removed.get(g.name, 0)
        if n > 0:
            groups.append(dataclasses.replace(g, n_devices=n))
    if not groups:
        raise ValueError("eviction would remove the whole cluster")
    return ClusterSpec(groups=tuple(groups))


def grow_cluster(spec: ClusterSpec, added: dict,
                 new_groups: Sequence = ()) -> ClusterSpec:
    """The grown cluster after admission: ``added`` maps existing group
    name → number of devices joining that group (a re-admitted host's
    devices); ``new_groups`` appends whole :class:`DeviceGroup` entries
    for hardware the cluster has never seen (a spot pool of a new kind).

    Group-keyed counterpart of ``runtime.elastic.HostTopology.with_host``
    and the symmetric inverse of :func:`shrink_cluster`.  Unknown group
    names, non-positive device counts, and name collisions between
    ``new_groups`` and live groups are loud errors — the admission
    machinery must never silently grow the wrong pool.
    """
    by_name = {g.name: g for g in spec.groups}
    for name, k in added.items():
        if name not in by_name:
            raise ValueError(f"unknown device group {name!r}; have "
                             f"{sorted(by_name)} (new hardware goes in "
                             "new_groups)")
        if k <= 0:
            raise ValueError(
                f"cannot add {k} devices to group {name!r}; a joining "
                "host must bring at least one device")
    seen = set(by_name)
    for g in new_groups:
        if g.name in seen:
            raise ValueError(
                f"new group {g.name!r} collides with an existing group; "
                "grow it via added= instead")
        if g.n_devices <= 0:
            raise ValueError(
                f"new group {g.name!r} offers n_devices={g.n_devices}")
        seen.add(g.name)
    groups = [dataclasses.replace(g, n_devices=g.n_devices
                                  + added.get(g.name, 0))
              for g in spec.groups]
    groups.extend(new_groups)
    return ClusterSpec(groups=tuple(groups))


def partition_cluster(spec: ClusterSpec, names: Sequence[str]
                      ) -> tuple:
    """Split ``spec`` into (named groups, the rest) — two ClusterSpecs.

    The prefill/decode router (the reference's serving/router.py) carves a
    mixed cluster into a prefill pool and a decode pool along *group*
    boundaries; this is the loud-error partition primitive it uses (the
    same idiom as :func:`shrink_cluster`): unknown names, duplicate
    names, taking every group, or taking none are all errors — a router
    must never silently serve from an empty pool.
    """
    by_name = {g.name: g for g in spec.groups}
    picked = list(names)
    if not picked:
        raise ValueError("partition needs at least one group name")
    if len(set(picked)) != len(picked):
        raise ValueError(f"duplicate group names in partition: {picked}")
    unknown = [n for n in picked if n not in by_name]
    if unknown:
        raise ValueError(f"unknown device groups {unknown}; have "
                         f"{sorted(by_name)}")
    if len(picked) == len(spec.groups):
        raise ValueError(
            "partition takes every group — the complement pool would be "
            "empty; a disaggregated deployment needs both pools populated")
    taken = tuple(g for g in spec.groups if g.name in set(picked))
    rest = tuple(g for g in spec.groups if g.name not in set(picked))
    return ClusterSpec(groups=taken), ClusterSpec(groups=rest)


def stage_groups_for(spec: ClusterSpec, strat: StrategySpec) -> tuple:
    """Map each of the ``pp`` stages to its hosting DeviceGroup.

    Stages are dealt to groups in declaration order, each group hosting
    ``n_g / (dp·tp)`` consecutive stages (whole stages never straddle a
    hardware boundary).
    """
    per_stage = strat.dp * strat.model_parallel
    out = []
    for g in spec.groups:
        out.extend([g] * (g.n_devices // per_stage))
    if len(out) != strat.pp:
        raise ValueError(
            f"{spec.n_devices} devices in groups {[g.name for g in spec.groups]}"
            f" do not tile {strat.pp} stages of {per_stage} devices")
    return tuple(out)


# ---------------------------------------------------------------------------
# mechanism 1: intra-stage throughput-proportional batch balancing
# ---------------------------------------------------------------------------


def _max_feasible_batch(meta: WorkloadMeta, strat: StrategySpec,
                        group: DeviceGroup) -> int:
    """Largest batch share whose peak memory fits the group's HBM
    (memory is monotone in batch via the activation/logits terms)."""
    def fits(b: int) -> bool:
        return step_cost(scale_meta_batch(meta, b), strat, group.hw).feasible

    if fits(meta.batch):
        return meta.batch
    if not fits(0):
        return -1           # params alone overflow — group unusable
    lo, hi = 0, meta.batch   # invariant: fits(lo), not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


def balance_batch(meta: WorkloadMeta, strat: StrategySpec,
                  spec: ClusterSpec) -> tuple:
    """Per-group batch shares ∝ effective group FLOP/s, HBM-capped.

    Returns one integer share per group, summing to ``meta.batch``; a
    uniform cluster gets an exactly even split.  Raises ``ValueError``
    when no assignment fits (the caller prunes such strategies).
    """
    per_replica = strat.model_parallel * strat.pp
    dp_g = [g.n_devices // per_replica for g in spec.groups]
    strat_g = [dataclasses.replace(strat, dp=max(d, 1)) for d in dp_g]
    caps = [_max_feasible_batch(meta, s, g)
            for s, g in zip(strat_g, spec.groups)]
    if any(c < 0 for c in caps):
        bad = [g.name for g, c in zip(spec.groups, caps) if c < 0]
        raise ValueError(f"groups {bad} cannot hold the model at all")

    weights = [d * g.device_flops for d, g in zip(dp_g, spec.groups)]
    n = len(spec.groups)
    shares = [0] * n
    free = list(range(n))
    remaining = meta.batch
    # clamp-and-redistribute: overweight groups pin at their HBM cap, the
    # excess re-splits proportionally among the rest
    while True:
        split = proportional_split(remaining, [weights[i] for i in free])
        over = [i for i, s in zip(free, split) if s > caps[i]]
        for i, s in zip(free, split):
            shares[i] = s
        if not over:
            break
        for i in over:
            shares[i] = caps[i]
            remaining -= caps[i]
            free.remove(i)
        if not free:
            if remaining > 0:
                raise ValueError(
                    f"global batch {meta.batch} exceeds the cluster's "
                    f"combined HBM capacity under {strat.describe()}")
            break
    assert sum(shares) == meta.batch
    return tuple(shares)


# ---------------------------------------------------------------------------
# mechanism 2: inter-stage latency-equalizing layer balancing
# ---------------------------------------------------------------------------


def graph_stage_partition(graph: ModelGraph, pp: int,
                          weights: Sequence[float]) -> list | None:
    """Min-max segment-respecting partition of ``graph`` into ``pp`` stages.

    Dynamic program over cut positions: stage ``s`` hosting layers
    ``[j, i)`` costs ``Σ layer_costs[j:i] / weights[s]`` (weights are the
    hosting groups' effective FLOP/s), spans restricted to
    ``graph.valid_span`` (subdivide one segment XOR union whole segments;
    atomic segments stay whole).  Returns per-stage layer counts, or
    ``None`` when no valid partition exists — the auto-search prunes such
    ``pp`` values.  On a single-segment graph with uniform weights this
    reduces to the even split.
    """
    L = graph.n_layers
    if pp < 1 or pp > L:
        return None
    lc = graph.layer_costs()
    pre = [0.0]
    for c in lc:
        pre.append(pre[-1] + c)
    return partition_min_max(
        graph, pp, lambda s, j, i: (pre[i] - pre[j]) / weights[s])


def partition_min_max(graph: ModelGraph, pp: int, span_cost) -> list | None:
    """Min-max DP over valid spans with an arbitrary per-span cost.

    ``span_cost(stage_idx, lo, hi) -> float`` (``inf`` = infeasible).
    The max-over-stages objective decomposes stage by stage because each
    span's cost depends only on its own layers and its own stage index —
    so this is exact, not a heuristic, for whatever pricing the caller
    plugs in.  Returns per-stage layer counts or ``None``.
    """
    L = graph.n_layers
    if pp < 1 or pp > L:
        return None
    inf = math.inf
    ok = graph.valid_span

    # best[s][i]: minimal max stage-cost covering layers [0, i) with s stages
    best = [[inf] * (L + 1) for _ in range(pp + 1)]
    cut = [[-1] * (L + 1) for _ in range(pp + 1)]
    best[0][0] = 0.0
    for s in range(1, pp + 1):
        for i in range(s, L - (pp - s) + 1):
            for j in range(s - 1, i):
                if best[s - 1][j] == inf or not ok(j, i):
                    continue
                c = max(best[s - 1][j], span_cost(s - 1, j, i))
                if c < best[s][i]:
                    best[s][i] = c
                    cut[s][i] = j
    if best[pp][L] == inf:
        return None
    counts, i = [], L
    for s in range(pp, 0, -1):
        j = cut[s][i]
        counts.append(i - j)
        i = j
    counts.reverse()
    return counts


def _balance_stages_graph(graph: ModelGraph, strat: StrategySpec,
                          spec: ClusterSpec) -> tuple:
    """Segment-aware stage balancing under FULL four-term pricing.

    The flat balancer's two-phase heuristic (flops-proportional split +
    memory repair) is unnecessary here: per-stage cost depends only on
    the stage's own span and hosting group, so the exact min-max
    partition under the complete ``step_cost`` (compute + comm + bubble,
    inf when HBM overflows) comes straight out of the span DP.  The
    flops/weight DP objective alone would misplace cuts on clusters whose
    binding term is the param-proportional gradient traffic, not compute.
    """
    sgroups = stage_groups_for(spec, strat)
    pp = strat.pp

    def span_cost(s: int, lo: int, hi: int) -> float:
        return step_cost(graph.stage_meta(lo, hi, pp), strat,
                         sgroups[s].hw).total        # inf when infeasible

    counts = partition_min_max(graph, pp, span_cost)
    if counts is None:
        if not graph.feasible_pp(pp):
            raise ValueError(
                f"no segment-respecting partition of {graph.describe()} "
                f"into {pp} stages")
        raise ValueError(f"no layer allocation over {pp} stages fits HBM")
    return sgroups, tuple(counts)


def balance_stages(meta, strat: StrategySpec,
                   spec: ClusterSpec) -> tuple:
    """(stage→group mapping, per-stage layer counts).

    Per-stage latency is ``layers_s / flops_s``; equalizing it means
    ``layers_s ∝ flops_s`` of the hosting group.  The integer allocation
    (≥1 layer per stage, summing to ``n_layers``) is then repaired
    against each stage's HBM: overweight stages shed layers one at a time
    to the feasible stage with the most compute headroom.

    ``meta`` may be a segment-aware :class:`ModelGraph`: multi-segment
    graphs route to the min-max DP allocator (stage spans respect segment
    edges, per-layer costs come from each segment's own arithmetic);
    single-segment graphs flatten and take the proportional path below
    byte-identically.
    """
    if isinstance(meta, ModelGraph):
        if len(meta.segments) > 1:
            return _balance_stages_graph(meta, strat, spec)
        meta = meta.workload_meta()
    sgroups = stage_groups_for(spec, strat)
    weights = [g.device_flops for g in sgroups]
    layers = proportional_split(meta.n_layers, weights, minimum=1)

    def cost_with(i: int, n: int) -> CostBreakdown:
        return step_cost(scale_meta_stage(meta, n, strat.pp),
                         strat, sgroups[i].hw)

    # memory repair: migrate layers off stages whose slice overflows HBM.
    # Takers are checked at their post-transfer layer count, so a move
    # never creates a new overflow (no donor/taker ping-pong).
    for _ in range(meta.n_layers):
        costs = [cost_with(i, layers[i]) for i in range(strat.pp)]
        over = [i for i, c in enumerate(costs) if not c.feasible]
        if not over:
            break
        donors = [i for i in over if layers[i] > 1]
        takers = [i for i, c in enumerate(costs)
                  if c.feasible and cost_with(i, layers[i] + 1).feasible]
        if not donors or not takers:
            raise ValueError(
                f"no layer allocation over {strat.pp} stages fits HBM")
        src = max(donors, key=lambda i: costs[i].mem_bytes
                  - sgroups[i].hw.hbm_bytes)
        dst = max(takers, key=lambda i: sgroups[i].hw.hbm_bytes
                  - costs[i].mem_bytes)
        layers[src] -= 1
        layers[dst] += 1
    if any(not cost_with(i, layers[i]).feasible for i in range(strat.pp)):
        raise ValueError(
            f"no layer allocation over {strat.pp} stages fits HBM")
    return sgroups, tuple(layers)


# ---------------------------------------------------------------------------
# combined placement + per-group cost (slowest group dominates)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UnitPlan:
    """One balanced unit of the placement: a replica group (``pp == 1``)
    or a pipeline stage (``pp > 1``)."""
    kind: str                  # "group" | "stage"
    group: DeviceGroup
    strategy: StrategySpec     # per-unit view (dp narrowed for groups)
    meta: WorkloadMeta         # workload re-scaled to this unit's share
    batch: int                 # batch share owned by this unit
    layers: int                # layers held (n_layers/pp when kind=group)
    cost: CostBreakdown


@dataclasses.dataclass(frozen=True)
class HeteroPlacement:
    """A hardware-aware assignment of work to a heterogeneous cluster."""
    spec: ClusterSpec
    strategy: StrategySpec
    units: tuple               # one UnitPlan per group (pp==1) / stage (pp>1)
    batch_shares: tuple        # per group, sums to the global batch
    layer_alloc: tuple         # per stage, sums to n_layers
    cost: CostBreakdown        # combined: max over units + cross-group comm

    @property
    def step_time(self) -> float:
        return self.cost.total

    def batch_slices(self) -> tuple:
        """Per-group ``(start, stop)`` offsets into the global batch —
        what a data loader uses to feed each hardware pool its share."""
        out, off = [], 0
        for b in self.batch_shares:
            out.append((off, off + b))
            off += b
        return tuple(out)

    def describe(self) -> str:
        bits = [f"{self.strategy.describe()} on "
                + "+".join(f"{g.n_devices}×{g.hw.name}"
                           for g in self.spec.groups)]
        if len(self.batch_shares) > 1:
            bits.append("batch=" + "/".join(str(b) for b in self.batch_shares))
        if self.strategy.pp > 1:
            bits.append("layers=" + "/".join(str(x) for x in self.layer_alloc))
        return " ".join(bits)


def _combine(units: Sequence[UnitPlan], extra_comm: float,
             detail: dict) -> CostBreakdown:
    """Max-reduce unit costs: the step is as slow as its slowest unit."""
    feasible = all(u.cost.feasible for u in units)
    worst = max(units, key=lambda u: (u.cost.total
                                      if u.cost.feasible else math.inf))
    detail = dict(detail)
    detail["units"] = {f"{u.kind}:{u.group.name}[{i}]": u.cost.detail
                      for i, u in enumerate(units)}
    return CostBreakdown(
        compute=worst.cost.compute,
        comm=worst.cost.comm + extra_comm,
        bubble=worst.cost.bubble,
        mem_bytes=max(u.cost.mem_bytes for u in units),
        feasible=feasible, detail=detail)


def price_batch_shares(meta: WorkloadMeta, strat: StrategySpec,
                       spec: ClusterSpec, shares, *,
                       overlap: float = 0.0) -> tuple:
    """Price an explicit per-group batch assignment (``pp == 1``).

    Returns ``(units, extra)``: one :class:`UnitPlan` per group with its
    share of the batch priced on its own hardware table, plus the
    cross-group gradient all-reduce on the cluster's bottleneck data link.
    This is the pricing kernel of :func:`plan_placement`, exposed so the
    calibration loop (profiler / fig_calibration / the drift controller)
    can re-price *stale* shares on a re-fitted ``ClusterSpec`` without
    re-running the balancer.
    """
    per_replica = strat.model_parallel
    dp_g = [g.n_devices // per_replica for g in spec.groups]
    us = []
    for g, d, b in zip(spec.groups, dp_g, shares):
        s_g = dataclasses.replace(strat, dp=max(d, 1))
        m_g = scale_meta_batch(meta, b)
        us.append(UnitPlan(
            kind="group", group=g, strategy=s_g, meta=m_g, batch=b,
            layers=meta.n_layers,
            cost=step_cost(m_g, s_g, g.hw, overlap=overlap)))
    ex = 0.0
    if len(spec.groups) > 1:
        # hierarchical DP reduction: in-group ring (already in each
        # unit's cost) + one cross-group ring on the bottleneck link
        # (nested ep: expert grads are ep-sharded → 1/ep the
        # volume; dense grads stay tp-sharded as in the flat path)
        if strat.ep > 1 and meta.expert_param_bytes:
            grad = ((meta.param_bytes - meta.expert_param_bytes)
                    / strat.tp
                    + meta.expert_param_bytes / strat.ep
                    ) * meta.grad_factor
        else:
            grad = meta.param_bytes * meta.grad_factor / strat.tp
        ex = all_reduce_time(grad, len(spec.groups),
                             spec.min_bw("data")) * (1.0 - overlap)
    return us, ex


def _plan_placement_graph(graph: ModelGraph, strat: StrategySpec,
                          spec: ClusterSpec, *, overlap: float = 0.0,
                          balanced: bool = True) -> HeteroPlacement:
    """Pipelined placement of a multi-segment graph: each stage priced
    from its own segments' arithmetic (modality-aware uneven stages)."""
    if not strategy_fits_cluster(strat, spec):
        raise ValueError(f"{strat.describe()} does not tile "
                         f"{[g.n_devices for g in spec.groups]} devices")
    detail: dict = {"placement": "balanced" if balanced else "naive",
                    "graph": graph.describe()}
    sgroups = stage_groups_for(spec, strat)
    pp = strat.pp

    def price_stages(layer_counts):
        units, off = [], 0
        for g, ls in zip(sgroups, layer_counts):
            m = graph.stage_meta(off, off + ls, pp)
            units.append(UnitPlan(
                kind="stage", group=g, strategy=strat, meta=m,
                batch=graph.batch, layers=ls,
                cost=step_cost(m, strat, g.hw, overlap=overlap)))
            off += ls
        return units

    even = tuple(proportional_split(graph.n_layers, [1.0] * pp, minimum=1))
    layers = even
    if balanced:
        try:
            sgroups, layers = _balance_stages_graph(graph, strat, spec)
        except ValueError:
            layers = even        # priced infeasible below, not raised
    units = price_stages(layers)
    if balanced and tuple(layers) != even and graph.valid_partition(even):
        # never-worse guard vs the even split, but only when the even
        # split is itself a legal (segment-respecting) partition
        u2 = price_stages(even)
        c1 = _combine(units, 0.0, detail)
        c2 = _combine(u2, 0.0, detail)
        if c2.feasible and (not c1.feasible or c2.total < c1.total):
            layers, units = even, u2
    cost = _combine(units, 0.0, detail)
    return HeteroPlacement(spec=spec, strategy=strat, units=tuple(units),
                           batch_shares=tuple([graph.batch]),
                           layer_alloc=tuple(layers), cost=cost)


def plan_placement(meta, strat: StrategySpec,
                   spec: ClusterSpec, *, overlap: float = 0.0,
                   balanced: bool = True) -> HeteroPlacement:
    """Balance ``meta`` under ``strat`` across ``spec`` and price it.

    ``balanced=False`` computes the *naive* placement (even batch shares /
    even layer split regardless of hardware) — the baseline that
    benchmarks/fig7_heterogeneous.py and fig10_multimodal.py compare
    against.

    ``meta`` may be a segment-aware :class:`ModelGraph`: unpipelined
    strategies and single-segment graphs flatten to the legacy meta (the
    pricing is byte-identical by construction); multi-segment graphs under
    ``pp > 1`` price each stage from its OWN segments' arithmetic
    (``ModelGraph.stage_meta``) and balance with the segment-respecting
    DP allocator.

    On a homogeneous spec the balanced and naive placements coincide and
    the combined cost equals ``step_cost`` on the single hardware table.
    """
    graph = meta if isinstance(meta, ModelGraph) else None
    meta = as_workload_meta(meta)
    if graph is not None and (len(graph.segments) == 1 or strat.pp == 1):
        graph = None            # flat pricing is exact for these
    if graph is not None:
        return _plan_placement_graph(graph, strat, spec,
                                     overlap=overlap, balanced=balanced)
    if not strategy_fits_cluster(strat, spec):
        raise ValueError(f"{strat.describe()} does not tile "
                         f"{[g.n_devices for g in spec.groups]} devices")
    detail: dict = {"placement": "balanced" if balanced else "naive"}
    units = []
    if strat.pp == 1:
        per_replica = strat.model_parallel
        dp_g = [g.n_devices // per_replica for g in spec.groups]

        def price(shares):
            return price_batch_shares(meta, strat, spec, shares,
                                      overlap=overlap)

        even = tuple(proportional_split(meta.batch, dp_g))
        shares = even
        if balanced:
            try:
                shares = balance_batch(meta, strat, spec)
            except ValueError:
                # no HBM-feasible assignment exists — price the even split
                # so callers see an infeasible CostBreakdown (mirroring
                # step_cost's semantics) instead of an exception
                shares = even
        units, extra = price(shares)
        if balanced and shares != even:
            # the even split is one point of the feasible share space — the
            # proportional heuristic (HBM-clamped, integerized) must never
            # return something worse than it
            u2, e2 = price(even)
            c1 = _combine(units, extra, detail)
            c2 = _combine(u2, e2, detail)
            if c2.feasible and (not c1.feasible or c2.total < c1.total):
                shares, units, extra = even, u2, e2
        if extra:
            detail["cross_group_allreduce"] = extra
        batch_shares = shares
        layer_alloc = tuple([meta.n_layers])
    else:
        sgroups = stage_groups_for(spec, strat)

        def price_stages(layer_counts):
            return [UnitPlan(
                kind="stage", group=g, strategy=strat,
                meta=scale_meta_stage(meta, ls, strat.pp),
                batch=meta.batch, layers=ls,
                cost=step_cost(scale_meta_stage(meta, ls, strat.pp), strat,
                               g.hw, overlap=overlap))
                for g, ls in zip(sgroups, layer_counts)]

        even = tuple(proportional_split(
            meta.n_layers, [1.0] * strat.pp, minimum=1))
        layers = even
        if balanced:
            try:
                sgroups, layers = balance_stages(meta, strat, spec)
            except ValueError:
                layers = even        # priced infeasible below, not raised
        units = price_stages(layers)
        if balanced and tuple(layers) != even:
            # same guard as the batch split: proportional-with-repair must
            # never lose to the even allocation it generalizes
            u2 = price_stages(even)
            c1 = _combine(units, 0.0, detail)
            c2 = _combine(u2, 0.0, detail)
            if c2.feasible and (not c1.feasible or c2.total < c1.total):
                layers, units = even, u2
        extra = 0.0
        batch_shares = tuple([meta.batch])
        layer_alloc = tuple(layers)
    cost = _combine(units, extra, detail)
    return HeteroPlacement(spec=spec, strategy=strat, units=tuple(units),
                           batch_shares=batch_shares,
                           layer_alloc=layer_alloc, cost=cost)


def hetero_step_cost(meta: WorkloadMeta, strat: StrategySpec,
                     spec: ClusterSpec, *, overlap: float = 0.0,
                     balanced: bool = True) -> CostBreakdown:
    """Four-term step cost on a heterogeneous cluster (slowest group wins).

    Single-group specs return **exactly** ``step_cost(meta, strat, hw)``
    up to the extra placement detail (regression-guarded).
    """
    return plan_placement(meta, strat, spec, overlap=overlap,
                          balanced=balanced).cost
