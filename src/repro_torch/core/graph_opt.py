"""Whale graph optimizations (paper §4): nested-strategy lowering, the port
of ``repro/core/graph_opt.py`` (pure Python over the port's IR and cost
model; equal to the reference's with ``==``).

The paper's claim is that two annotation primitives — ``replicate`` and
``split`` — plus *graph optimizations* applied by the framework suffice to
express every hybrid the giant-model zoo needs, including the **nested**
combination that trained M6 (data-parallel replicas each containing
expert-split MoE layers).  This module is that compiler.  It consumes a
:class:`~repro_torch.core.ir.TaskGraph` whose subgraphs carry stacked
(nested) :class:`~repro_torch.core.ir.StrategyAnnotation`\\ s and lowers
it in four passes:

1. **Nesting validation** (:func:`validate_nesting`): the legal nest
   grammar.  ``split`` is always innermost; ``stage`` needs an enclosing
   ``pipeline``; no kind nests inside itself.  Supported shapes include the
   paper's ``replica{split}`` (DP outer, expert/tensor split inner) and the
   three-level ``pipeline{stage{replica{split}}}``.  Illegal nests raise
   :class:`StrategyNestingError` at scope *entry* (``strategies.py``
   calls in), so the error points at the offending ``with`` line.
2. **Subgraph replication** (:func:`replication_degree`): how many copies
   of each subgraph the mesh executes, from its replica ancestry.
3. **Bridge insertion** (:func:`insert_bridges`): consecutive subgraphs
   with different layouts get a :class:`~repro_torch.core.ir.Bridge` —
   identity, all-gather / reduce-scatter at replicate⇄split edges,
   all-to-all at expert-split boundaries (MoE dispatch/combine), p2p at
   stage boundaries.  Each bridge records its autodiff transpose, the mesh-axis
   family it rides, and the payload bytes (priced by :func:`bridge_cost`
   with the ring formulas of :mod:`repro_torch.core.cost_model`).
4. **Gradient-aggregation placement** (:func:`place_grad_aggregation`):
   every parameter-carrying subgraph under a ``replica`` scope gets its
   gradient all-reduce placed on the data axes — at 1/ep the volume for
   expert-split params, whose shards own disjoint experts.

:func:`lower` runs all four and returns a :class:`LoweredGraph` (bridges +
aggregations + the derived nested :class:`StrategySpec`);
:func:`compile_nested_plan` threads it into the engine, yielding an
executable :class:`~repro_torch.core.planner.ExecutionPlan` for the nested
hybrid.  :class:`~repro_torch.core.ir.Bridge` documents the bridge
taxonomy.  The bridges and aggregations are the graph optimizer's record:
the port's engine runs the collectives they name explicitly, where the
plan's layout needs them (``core/sharding.py``'s ``copy_to``,
``reduce_from`` and ``gather_along``; the pipeline's point-to-point; the
data-parallel all-reduce of ``ExecutionPlan.train_step_fn``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cost_model import (StrategySpec, all_gather_time,
                                         all_reduce_time, all_to_all_time,
                                         p2p_time, reduce_scatter_time)
from repro_torch.core.ir import (PARALLEL_KINDS, Bridge, Edge, Subgraph,
                                 TaskGraph)
from repro_torch.launch.mesh import mesh_shape


class StrategyNestingError(ValueError):
    """An illegal strategy-scope nest (raised at scope entry)."""


# ---------------------------------------------------------------------------
# pass 1: nesting validation
# ---------------------------------------------------------------------------

def validate_nesting(kinds, *, entering: str | None = None,
                     in_cluster: bool = True) -> tuple:
    """Validate a scope stack (outer→inner annotation kinds).

    ``kinds`` is the stack *before* ``entering`` is pushed (pass
    ``entering=None`` to validate a complete recorded stack).  Returns the
    canonical tuple of parallel kinds; raises :class:`StrategyNestingError`
    with an actionable message otherwise.
    """
    stack = [k for k in kinds if k in PARALLEL_KINDS]
    if entering is not None:
        if entering in PARALLEL_KINDS and not in_cluster:
            raise StrategyNestingError(
                f"'{entering}' scope outside any wh.cluster(): strategy "
                f"scopes annotate the active cluster's TaskGraph — open a "
                f"`with wh.cluster(...):` block first")
        stack = stack + [entering] if entering in PARALLEL_KINDS else stack
    for i, kind in enumerate(stack):
        outer = stack[:i]
        if kind in outer:
            raise StrategyNestingError(
                f"'{kind}' scope nested inside another '{kind}' "
                f"(stack: {' > '.join(outer)} > {kind}); each strategy "
                f"kind may appear once per nest")
        if "split" in outer:
            raise StrategyNestingError(
                f"'{kind}' scope nested inside 'split' "
                f"(stack: {' > '.join(outer)} > {kind}); split is an "
                f"operator sharding and must be the innermost scope")
        if kind == "stage" and "pipeline" not in outer:
            raise StrategyNestingError(
                "'stage' scope without an enclosing 'pipeline' — stages "
                "are pipeline boundaries (wh.pipeline(...) > wh.stage())")
        if kind == "pipeline" and "stage" in outer:
            raise StrategyNestingError(
                "'pipeline' scope nested inside a 'stage' — pipelines "
                "cannot nest in their own stages")
    return tuple(stack)


# ---------------------------------------------------------------------------
# pass 2: subgraph replication
# ---------------------------------------------------------------------------

def replication_degree(sg: Subgraph, mesh_axes: dict) -> int:
    """How many replicas of ``sg`` the mesh runs (its replica ancestry ×
    the data-axis sizes; 1 when the subgraph is not under a replica)."""
    if "replica" not in sg.parallel_kinds():
        return 1
    n = 1
    for a in ("pod", "data"):
        n *= mesh_axes.get(a, 1)
    return n


# ---------------------------------------------------------------------------
# pass 3: bridge insertion
# ---------------------------------------------------------------------------

def _layout(sg: Subgraph) -> tuple:
    """(stage_index, has_replica, split_kind) — split_kind ∈
    {None, "split", "expert"}."""
    kinds = sg.parallel_kinds()
    split = None
    if "split" in kinds:
        opts = sg.split_options() or {}
        split = "expert" if opts.get("experts") else "split"
    return (sg.stage_index(), "replica" in kinds, split)


def plan_bridge(src: Subgraph, dst: Subgraph) -> Bridge:
    """The collective glue for the ``src → dst`` boundary (Whale §4).

    Rules, in precedence order:
    - different pipeline stages → ``p2p`` over the stage axis
    - expert-split on exactly one side → ``all_to_all`` over the model
      axis (MoE token dispatch entering, combine leaving; self-transpose)
    - split on the destination only → ``all_gather`` (replicas' batch
      shards gathered so every split shard sees the full input; transpose
      ``reduce_scatter``)
    - split on the source only → ``reduce_scatter`` (partial-sum combine
      + batch re-scatter onto the replicas; transpose ``all_gather``)
    - same layout → ``identity``
    """
    payload = sum(t.bytes for t in src.outputs)
    s_stage, s_rep, s_split = _layout(src)
    d_stage, d_rep, d_split = _layout(dst)
    if (s_stage is not None or d_stage is not None) and s_stage != d_stage:
        # covers stage→stage AND pipeline entry/exit (stage on one side):
        # the boundary activation still moves off/onto the stage's devices
        def _n(s):
            return "outside" if s is None else f"stage {s}"
        return Bridge(kind="p2p", bwd_kind="p2p", axis="stage",
                      bytes=payload,
                      reason=f"{_n(s_stage)} → {_n(d_stage)}")
    if (s_split == "expert") != (d_split == "expert"):
        way = "dispatch" if d_split == "expert" else "combine"
        return Bridge(kind="all_to_all", bwd_kind="all_to_all",
                      axis="model", bytes=payload,
                      reason=f"expert {way} at a replica⇄split[experts] edge")
    if s_split is None and d_split is not None:
        return Bridge(kind="all_gather", bwd_kind="reduce_scatter",
                      axis="model", bytes=payload,
                      reason="replicate → split: gather batch shards so "
                             "every split shard sees the full input")
    if s_split is not None and d_split is None:
        return Bridge(kind="reduce_scatter", bwd_kind="all_gather",
                      axis="model", bytes=payload,
                      reason="split → replicate: combine partial sums and "
                             "re-scatter the batch onto the replicas")
    return Bridge(kind="identity", bwd_kind="identity", axis="",
                  bytes=0, reason="layouts agree")


def insert_bridges(tg: TaskGraph) -> list:
    """Walk consecutive subgraph pairs, planning one bridge per edge.

    Populates (and returns) ``tg.edges``; idempotent — re-lowering a graph
    replaces its edges rather than appending duplicates.
    """
    tg.edges = []
    for src, dst in zip(tg.nodes, tg.nodes[1:]):
        tg.add_edge(Edge(src=src.name, dst=dst.name,
                         bridge=plan_bridge(src, dst)))
    return tg.edges


def bridge_cost(bridge: Bridge, hw, n: int) -> float:
    """Wall-time of one bridge crossing on ``hw`` with ``n`` participants,
    using the ring-collective formulas the cost model prices."""
    if bridge.kind == "identity" or n <= 1:
        return 0.0
    bw = hw.bw_for_axis(bridge.axis or "model")
    if bridge.kind == "all_gather":
        return all_gather_time(bridge.bytes, n, bw)
    if bridge.kind == "reduce_scatter":
        return reduce_scatter_time(bridge.bytes, n, bw)
    if bridge.kind == "all_to_all":
        return all_to_all_time(bridge.bytes, n, bw)
    if bridge.kind == "p2p":
        return p2p_time(bridge.bytes, bw)
    if bridge.kind == "all_reduce":
        return all_reduce_time(bridge.bytes, n, bw)
    raise ValueError(f"unknown bridge kind {bridge.kind!r}")


# ---------------------------------------------------------------------------
# pass 4: gradient-aggregation placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradAgg:
    """Where one subgraph's gradient reduction runs (Whale §4: gradient
    aggregation is placed at the outermost replicate scope)."""
    subgraph: str
    collective: str            # "all_reduce" | "none"
    axes: tuple                # mesh-axis families the reduction rides
    bytes: float               # per-shard payload
    note: str = ""


def place_grad_aggregation(tg: TaskGraph, *, ep: int = 1,
                           tp: int = 1) -> list:
    """One :class:`GradAgg` per parameter-carrying subgraph.

    Replicated params all-reduce their grads over the data axes.  Under a
    nested expert split the expert shards own disjoint experts, so the
    aggregation stays on the data axes at ``1/ep`` the volume; a plain
    (tensor) split leaves grads model-sharded, so its per-shard data-axis
    reduction moves ``1/tp`` the volume.  Subgraphs outside any replica
    scope need no aggregation (their params live on exactly one device
    group).
    """
    out = []
    for sg in tg.nodes:
        if not sg.params:
            continue
        kinds = sg.parallel_kinds()
        pb = float(sg.param_bytes)
        if "replica" not in kinds:
            out.append(GradAgg(subgraph=sg.name, collective="none",
                               axes=(), bytes=0.0,
                               note="no replica scope — single owner"))
            continue
        opts = sg.split_options() or {}
        if "split" in kinds and opts.get("experts"):
            out.append(GradAgg(
                subgraph=sg.name, collective="all_reduce", axes=("data",),
                bytes=pb / max(ep, 1),
                note="expert-split: shards own disjoint experts — "
                     "data-axis reduction at 1/ep volume"))
        elif "split" in kinds:
            out.append(GradAgg(
                subgraph=sg.name, collective="all_reduce", axes=("data",),
                bytes=pb / max(tp, 1),
                note="tensor-split: model-sharded grads reduce over data "
                     "at 1/tp volume per shard"))
        else:
            out.append(GradAgg(
                subgraph=sg.name, collective="all_reduce", axes=("data",),
                bytes=pb, note="replicated params reduce over data"))
    return out


# ---------------------------------------------------------------------------
# the lowering driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoweredGraph:
    """The graph optimizer's output: a validated, bridged TaskGraph plus
    the nested strategy it implies.  ``replication`` maps each subgraph
    name to the number of copies the mesh runs (pass 2)."""
    taskgraph: TaskGraph
    strategy: StrategySpec
    edges: list
    grad_aggs: list
    replication: dict = dataclasses.field(default_factory=dict)

    @property
    def max_nesting_depth(self) -> int:
        return max((sg.nesting_depth for sg in self.taskgraph.nodes),
                   default=0)

    def bridges(self, kind: str | None = None) -> list:
        bs = [e.bridge for e in self.edges]
        return bs if kind is None else [b for b in bs if b.kind == kind]

    def describe(self) -> str:
        n_comm = sum(1 for b in self.bridges() if b.kind != "identity")
        return (f"{self.strategy.describe()} | depth "
                f"{self.max_nesting_depth} | {len(self.edges)} edges "
                f"({n_comm} bridged) | "
                + ", ".join(f"{e.src}→{e.dst}:{e.bridge.kind}"
                            for e in self.edges if e.bridge.kind != "identity"))


def lower(cluster) -> LoweredGraph:
    """Run the four optimization passes over ``cluster``'s TaskGraph."""
    tg = cluster.taskgraph
    if tg is None or not tg.nodes:
        raise ValueError("cluster has no recorded TaskGraph — trace the "
                         "model under `with wh.cluster(...):` first")
    for sg in tg.nodes:
        validate_nesting(sg.strategy_kinds())
    from repro_torch.core.planner import strategy_from_taskgraph
    strat = strategy_from_taskgraph(cluster)
    mesh_axes = mesh_shape(cluster.mesh)
    repl = {sg.name: replication_degree(sg, mesh_axes) for sg in tg.nodes}
    edges = insert_bridges(tg)
    aggs = place_grad_aggregation(tg, ep=strat.ep, tp=strat.tp)
    return LoweredGraph(taskgraph=tg, strategy=strat, edges=edges,
                        grad_aggs=aggs, replication=repl)


def compile_nested_plan(cluster, model, *, workload_meta=None,
                        overlap: float = 0.0):
    """Lower the recorded nested annotations and hand the result to the
    engine: cluster + model → :class:`~repro_torch.core.planner.ExecutionPlan`.

    The returned plan's ``strategy`` carries the nested degrees (``dp``,
    ``tp``/``ep``, ``pp``) the graph optimizer derived; on a
    mixed-hardware ``cluster.spec`` the plan is balanced by
    :mod:`repro_torch.core.hetero` exactly as explicit-strategy plans are.
    """
    lowered = lower(cluster)
    from repro_torch.core.planner import compile_plan
    return compile_plan(model, cluster.mesh, strategy=lowered.strategy,
                        cluster_spec=getattr(cluster, "spec", None),
                        workload_meta=workload_meta, overlap=overlap)
