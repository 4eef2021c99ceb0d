"""Whale strategy primitives (paper §2, Cases 1–5), the port of
``repro/core/strategies.py``.

Scopes are context managers that record strategy annotations into the
active Cluster's TaskGraph (the Whale IR) for the ``wh.sub``-wrapped
subgraphs called inside them.  The layout they name runs through the
plan the graph optimizer compiles from the recorded graph
(:func:`~repro_torch.core.graph_opt.compile_nested_plan`,
:func:`~repro_torch.core.planner.compile_plan_from_cluster`): the port's
collectives are explicit calls of that plan, so ``wh.sub`` itself
computes exactly what the function it wraps computes (see :func:`sub`).

    with wh.cluster(mesh_shape=(2, 2), axis_names=("data", "model")):
        with wh.replica():                      # Case 1: data parallel
            h = wh.sub("backbone", net)(p1, x)
        with wh.split(dim=-1):                  # Case 2: + operator sharding
            logits = wh.sub("fc", head)(p2, h)

``auto_parallel`` (Case 5) marks the graph for strategy search by
:mod:`repro_torch.core.auto`.
"""
from __future__ import annotations

import functools
import threading

import torch

from repro_torch.core.ir import (StrategyAnnotation, Subgraph, TaskGraph,
                                 capture_meta, tensor_leaves)
from repro_torch.core.vdevice import Cluster

_tls = threading.local()


def _stack() -> list:
    if not hasattr(_tls, "scopes"):
        _tls.scopes = []
    return _tls.scopes


class _Scope:
    kind = "?"

    def __init__(self, **options):
        self.options = options

    def __enter__(self):
        # loud nesting errors at the offending `with` line: graph_opt owns
        # the legality rules (split innermost, stage needs pipeline, no
        # self-nesting, parallel scopes need an active cluster)
        from repro_torch.core.graph_opt import validate_nesting
        stack = _stack()
        validate_nesting([a.kind for a in stack], entering=self.kind,
                         in_cluster=Cluster.current() is not None)
        stack.append(StrategyAnnotation(self.kind, dict(self.options),
                                        depth=len(stack)))
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


class replica(_Scope):
    """Data parallelism: batch dim replicated model, sharded data."""
    kind = "replica"


class split(_Scope):
    """Operator sharding along `dim` of the subgraph output (paper Fig 4).

    ``experts=True`` marks the split as *expert parallelism* over the MoE
    ``experts`` dimension — nested inside ``replica`` this is the paper's
    ``replicate{split}`` M6 hybrid, lowered by
    :mod:`repro_torch.core.graph_opt` with all-to-all dispatch/combine
    bridges instead of the all-gather/reduce-scatter of a tensor split.
    """
    kind = "split"

    def __init__(self, dim: int = -1, experts: bool = False):
        super().__init__(dim=dim, experts=experts)


class stage(_Scope):
    """Model-parallel stage boundary (paper Case 3)."""
    kind = "stage"
    _counter = 0

    def __enter__(self):
        self.options["index"] = stage._counter
        stage._counter += 1
        return super().__enter__()


class pipeline(_Scope):
    """GPipe-style pipelining of enclosed stages (paper Case 4)."""
    kind = "pipeline"

    def __init__(self, micro_batch: int = 4):
        super().__init__(micro_batch=micro_batch)
        stage._counter = 0


class auto_parallel(_Scope):
    """Case 5: let the engine pick the strategy via the cost model."""
    kind = "auto"


def cluster(*args, **kwargs) -> Cluster:
    return Cluster(*args, **kwargs)


def current_annotations() -> list:
    return list(_stack())


# ---------------------------------------------------------------------------
# wh.sub — subgraph capture
# ---------------------------------------------------------------------------

def _in_backward() -> bool:
    """Whether autograd is running a backward pass on this thread: a
    checkpoint recomputing a forward (on the CPU on the caller's thread,
    on the card on the engine's own)."""
    return torch._C._current_graph_task_id() != -1


def _signature(sg: Subgraph) -> tuple:
    return ([(a.kind, a.options, a.depth) for a in sg.strategy], sg.inputs,
            sg.outputs, sg.params, sg.flops, sg.vdevice)


def record(tg: TaskGraph, sg: Subgraph) -> None:
    """Add ``sg`` to ``tg`` under the port's recording rule: one node per
    name.  A name not yet recorded is appended.  A recorded name is the
    same subgraph run again (a second forward, a second step) when it is
    the node after the one last recorded or replayed (the first after the
    last: the calls replay the recorded names in order) and its signature
    (annotations, metas, FLOPs, virtual device) is equal; it records
    nothing.  Anything else — a name recorded twice in one pass, or again
    with another signature — raises ``ValueError``, so a repeated call
    never silently doubles the graph's layers."""
    names = [n.name for n in tg.nodes]
    if sg.name not in names:
        tg.add(sg)
        tg.last_recorded = len(tg.nodes) - 1
        return
    at = names.index(sg.name)
    if at != (tg.last_recorded + 1) % len(names):
        raise ValueError(
            f"wh.sub({sg.name!r}) is already node {at} of the TaskGraph: "
            f"each subgraph needs a name of its own (e.g. 'block0', "
            f"'block1', …), and a later pass replays the recorded names in "
            f"order")
    if _signature(tg.nodes[at]) != _signature(sg):
        raise ValueError(f"wh.sub({sg.name!r}) was recorded with other "
                         f"annotations, shapes or FLOPs")
    tg.last_recorded = at


def sub(name: str, fn):
    """Wrap ``fn`` as a named Whale Subgraph.  Under an active cluster,
    calling the wrapper records IR metadata (abstract: :func:`capture_meta`
    on meta tensors) into the cluster's TaskGraph by :func:`record`'s rule,
    then calls ``fn`` and returns its output unchanged.

    The reference also applies the enclosing strategy's GSPMD sharding
    constraint to the output (``with_sharding_constraint``): a layout hint
    that changes no value.  The port has no GSPMD: its collectives are
    explicit calls of the plan compiled from the recorded graph
    (:func:`~repro_torch.core.graph_opt.compile_nested_plan`), so ``sub``
    executes no per-call layout.  A call inside a backward pass (a
    checkpoint's recompute) records nothing.  To record a model without
    allocating, call it on meta tensors inside
    :func:`repro_torch.kernels.abstract` (its kernels' wrappers then take
    their plain versions)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        cl = Cluster.current()
        if cl is None or _in_backward():
            return fn(*args, **kwargs)
        anns = current_annotations()
        inputs, outputs, flops, _ = capture_meta(
            lambda *a: fn(*a, **kwargs), *args)
        # convention: a leading dict positional arg is the param tree —
        # record its leaves (sorted key order) as Subgraph.params (used by
        # the auto-parallel cost path), the rest as data inputs.
        params_meta, data_meta = [], inputs
        if args and isinstance(args[0], dict):
            n_param_leaves = len(tensor_leaves(args[0]))
            params_meta = inputs[:n_param_leaves]
            data_meta = inputs[n_param_leaves:]
        sg = Subgraph(name=name, fn=fn, strategy=anns,
                      inputs=data_meta, outputs=outputs, flops=flops,
                      params=params_meta)
        kinds = sg.strategy_kinds()
        if "stage" in kinds:
            idx = next(a.options["index"] for a in anns if a.kind == "stage")
            sg.vdevice = cl.stage_vd(idx)
        elif "split" in kinds and "replica" in kinds:
            # nested replica{split}: the subgraph spans data AND model axes
            sg.vdevice = cl.hybrid_vd()
        elif "split" in kinds:
            sg.vdevice = cl.split_vd()
        elif "replica" in kinds:
            sg.vdevice = cl.replica_vd()
        record(cl.taskgraph, sg)
        return fn(*args, **kwargs)

    return wrapper
