"""Whale IR: strategy-annotated subgraphs with meta-driven cost capture,
the port of ``repro/core/ir.py``.

A :class:`Subgraph` records (a) the callable, (b) its strategy annotation
(from the enclosing scopes), (c) *metadata* captured abstractly — tensor
shapes and dtypes, and the forward FLOPs — with no execution on any
device and no device allocation.  This is the paper's "meta-driven"
methodology (§2: "Different from the dry-run methodology, we use a
meta-driven method").  The reference traces with ``jax.eval_shape`` and
walks the jaxpr; here :func:`capture_meta` runs the function once on
``device="meta"`` copies of its arguments (shapes and dtypes, no storage)
and :func:`graph_flops` counts the products the dispatcher sees, with
:class:`torch.utils.flop_counter.FlopCounterMode`.

The :class:`TaskGraph` is the sequential composition of subgraphs (Whale's
models are layered pipelines; general DAGs reduce to this for the
strategies in the paper).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """Multi-Dimension tensor metadata (abstraction #2); ``dtype`` is a
    :class:`torch.dtype`."""
    shape: tuple
    dtype: Any
    logical_axes: tuple | None = None

    @property
    def bytes(self) -> int:
        return int(math.prod(self.shape)) * self.dtype.itemsize


@dataclasses.dataclass
class StrategyAnnotation:
    kind: str                      # replica | split | stage | pipeline | auto
    options: dict = dataclasses.field(default_factory=dict)
    depth: int = 0                 # nesting depth at which the scope opened
                                   # (0 = outermost; recorded by strategies)


# Parallelism-bearing annotation kinds, outermost-legal first.  "auto" is a
# marker for the search, not a layout, and never participates in nesting
# legality (repro_torch.core.graph_opt.validate_nesting owns the rules).
PARALLEL_KINDS = ("pipeline", "stage", "replica", "split")


@dataclasses.dataclass(frozen=True)
class Bridge:
    """Collective glue inserted at a strategy boundary (Whale §4).

    The forward collective ``kind`` and its autodiff transpose ``bwd_kind``
    ride mesh-axis family ``axis``; ``bytes`` is the forward payload (the
    source subgraph's boundary activations).  Taxonomy:

    - ``identity``        same layout on both sides — no comm
    - ``all_gather``      replicate → split edge (fwd); transpose is
      ``reduce_scatter``
    - ``reduce_scatter``  split → replicate edge (partial-sum combine +
      batch re-scatter); transpose is ``all_gather``
    - ``all_to_all``      expert-split boundary (MoE dispatch/combine) —
      self-transpose
    - ``p2p``             pipeline stage boundary — self-transpose
    """
    kind: str
    bwd_kind: str
    axis: str
    bytes: int = 0
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class Edge:
    """A directed dataflow edge between two named subgraphs, carrying the
    bridge the graph optimizer inserted for their layout mismatch."""
    src: str
    dst: str
    bridge: Bridge


@dataclasses.dataclass
class Subgraph:
    """Unit of parallelism (abstraction #1)."""
    name: str
    fn: Callable | None
    strategy: list                 # stack of StrategyAnnotation (outer→inner)
    inputs: list = dataclasses.field(default_factory=list)    # TensorMeta
    outputs: list = dataclasses.field(default_factory=list)   # TensorMeta
    params: list = dataclasses.field(default_factory=list)    # TensorMeta
    flops: int = 0                 # fwd FLOPs, meta-derived
    vdevice: Any = None

    @property
    def param_bytes(self) -> int:
        return sum(t.bytes for t in self.params)

    @property
    def activation_bytes(self) -> int:
        return sum(t.bytes for t in self.outputs)

    def strategy_kinds(self) -> tuple:
        return tuple(s.kind for s in self.strategy)

    def parallel_kinds(self) -> tuple:
        """Layout-bearing annotation kinds, outer→inner (drops ``auto``)."""
        return tuple(s.kind for s in self.strategy if s.kind in PARALLEL_KINDS)

    @property
    def nesting_depth(self) -> int:
        """How many parallelism scopes enclose this subgraph (the paper's
        nested-hybrid depth: replica{split} = 2, pipeline{replica{split}},
        counted per layout scope — stage boundaries included)."""
        return len(self.parallel_kinds())

    def stage_index(self) -> int | None:
        for s in self.strategy:
            if s.kind == "stage":
                return s.options.get("index")
        return None

    def split_options(self) -> dict | None:
        for s in reversed(self.strategy):     # innermost split wins
            if s.kind == "split":
                return s.options
        return None


@dataclasses.dataclass
class TaskGraph:
    nodes: list = dataclasses.field(default_factory=list)
    # dataflow edges + their inserted bridges, populated by the graph
    # optimizer (repro_torch.core.graph_opt.insert_bridges)
    edges: list = dataclasses.field(default_factory=list)
    # the node wh.sub last recorded or replayed (core/strategies.py record)
    last_recorded: int = dataclasses.field(default=-1, repr=False,
                                           compare=False)

    def add(self, sg: Subgraph) -> Subgraph:
        self.nodes.append(sg)
        return sg

    def add_edge(self, edge: Edge) -> Edge:
        self.edges.append(edge)
        return edge

    def edges_into(self, name: str) -> list:
        return [e for e in self.edges if e.dst == name]

    def by_name(self, name: str) -> Subgraph:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def cluster_repeats(self) -> list:
        """Group structurally-identical consecutive nodes (paper §1 item 3:
        'groups repeatedly occurred sub-structures to prune the search
        space').  Two nodes are identical if their param/output signatures
        and strategies match."""
        groups: list = []
        for n in self.nodes:
            sig = (tuple((t.shape, str(t.dtype)) for t in n.params),
                   tuple((t.shape, str(t.dtype)) for t in n.outputs),
                   n.strategy_kinds())
            if groups and groups[-1]["sig"] == sig:
                groups[-1]["nodes"].append(n)
            else:
                groups.append({"sig": sig, "nodes": [n]})
        return groups


# ---------------------------------------------------------------------------
# meta-driven FLOPs: count the products the dispatcher sees
# ---------------------------------------------------------------------------

def graph_flops(fn: Callable, *args) -> int:
    """Forward FLOPs of ``fn(*args)``: the reference's ``jaxpr_flops``
    over the graph of ATen operators the call dispatches.  Products count
    2·out·K (``mm``, ``bmm``, ``addmm``, ``baddbmm``, and the ``einsum``s
    and ``matmul``s that lower to them), convolutions 2·out·kh·kw·Cin;
    nothing else.  A Python loop counts each trip (the reference's scan
    length), a checkpointed function once (its forward).  Run it on meta
    tensors (:func:`capture_meta` does) to execute nothing."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


def tensor_leaves(tree) -> list:
    """The tensors of a tree of dicts (sorted keys, ``jax.tree.leaves``'
    order), lists and tuples; other leaves are not tensors and are left
    out."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tensor_leaves(v)]
    return []


def to_meta(tree):
    """``tree`` with each tensor replaced by an empty one of its shape and
    dtype on the ``meta`` device (no storage); other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree


def capture_meta(fn: Callable, *args, logical_axes=None) -> tuple:
    """``fn(*args)`` once on meta copies of ``args`` under
    :func:`graph_flops` — fully abstract: no storage, no launch.  Returns
    (input metas, output metas, FLOPs, the output tree of meta tensors),
    as the reference's ``eval_shape`` + jaxpr walk.  Inside it the kernels'
    wrappers take their plain versions on meta tensors
    (:func:`repro_torch.kernels.abstract`)."""
    meta_args = to_meta(args)
    out = []
    with kernels.abstract():
        flops = graph_flops(lambda *a: out.append(fn(*a)), *meta_args)

    def metas(tree):
        return [TensorMeta(tuple(x.shape), x.dtype)
                for x in tensor_leaves(tree)]

    return metas(args), metas(out[0]), flops, out[0]
