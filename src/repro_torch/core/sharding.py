"""Multi-Dimension → mesh mapping (Whale's unified dimension abstraction),
the port of ``repro/core/sharding.py``.

Tensors are annotated with *logical* dimension names ("batch", "q_heads",
"mlp", "vocab", ...).  A :class:`ShardingRules` maps each logical name to
zero or more mesh axes; the planner makes it from the strategy
(:func:`rules_for_strategy`).  Models never name a mesh axis: they ask the
active rules (:func:`current_rules`, set by :func:`use_rules`) whether a
logical dimension is split (:func:`split_of`).

A spec is a plain tuple with one entry per dim: ``None`` (replicated), an
axis name, or a tuple of axis names (the block index is mixed-radix over
them, the first axis major), as the reference's ``PartitionSpec``.
Divisibility pruning and first-come-wins follow the reference: a dim its
axes do not divide stays replicated, and an axis shards one dim at most.
A pipeline's leaves take the reference's :func:`staged_specs` (the stacked
``layers`` dim over ``stage``, nothing over the data axes).

Where GSPMD places the collectives of a sharded program implicitly, the
port writes each one: :func:`shard_leaf` / :func:`gather_leaf` cut a full
leaf into this rank's block and gather it back, and three autograd
collectives carry tensor parallelism and ZeRO-3 —

- :func:`copy_to`: identity forward, all-reduce backward (the input of a
  column-parallel product: each rank's input gradient is partial);
- :func:`reduce_from`: all-reduce forward, identity backward (the output of
  a row-parallel product);
- :func:`gather_along`: all-gather forward, reduce-scatter backward (a
  ZeRO-3 parameter slice gathered at its use);

and :func:`mean_from` (mean forward, identity backward) takes a statistic
of the batch, the experts' balance, over the data axes
(:func:`batch_splits`) where GSPMD would take it over the global batch.

Collectives over several axes run one axis at a time on the mesh's
one-axis groups (a gather over ``("pod", "data")`` gathers over ``data``,
then ``pod``), so no other group is ever made.  Under gloo a CUDA tensor
crosses through host memory for the gather and the reduce-scatter, which
gloo carries for host tensors only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.tree import flatten, unflatten

_tls = threading.local()


def _axes(entry) -> tuple:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _is_names(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in t)


@dataclasses.dataclass
class ShardingRules:
    """``shape``: the mesh's {axis: size}; ``rules``: logical name → mesh
    axes; ``mesh``: the :class:`~torch.distributed.device_mesh.DeviceMesh`
    whose groups carry the collectives (``None``: specs only)."""
    shape: dict
    rules: dict = dataclasses.field(default_factory=dict)
    mesh: object = None

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        n = 1
        for a in _axes(axes):
            n *= self.shape.get(a, 1)
        return n

    def spec_for(self, names: Sequence[str | None],
                 shape: Sequence[int] | None = None) -> tuple:
        """The spec of logical dims ``names``, pruning trailing axes until
        the dim divides; an axis already used is skipped (first come
        wins)."""
        used: set = set()
        parts = []
        for i, name in enumerate(names):
            assigned = self.rules.get(name) if name is not None else None
            axes = tuple(a for a in _axes(assigned)
                         if a in self.shape and a not in used)
            if shape is not None:
                while axes and shape[i] % self.axis_size(axes):
                    axes = axes[:-1]
            if not axes:
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes[0] if len(axes) == 1 else axes)
        return tuple(parts)

    def param_spec(self, names: Sequence[str | None], shape: Sequence[int],
                   *, fsdp_axes: Sequence[str] = (),
                   min_fsdp_size: int = 65536) -> tuple:
        """The tensor-parallel spec from the rules, with the ZeRO-3/FSDP
        extension: the largest still-unsharded, divisible, non-``layers``
        dim of a leaf of at least ``min_fsdp_size`` elements takes the
        data axes."""
        spec = self.spec_for(names, shape)
        fa = tuple(a for a in fsdp_axes if a in self.shape)
        if not fa or math.prod(shape) < min_fsdp_size:
            return spec
        used = {a for p in spec for a in _axes(p)}
        fa = tuple(a for a in fa if a not in used)
        if not fa:
            return spec
        n = self.axis_size(fa)
        cands = [i for i in range(len(shape))
                 if spec[i] is None and names[i] != "layers"
                 and shape[i] % n == 0]
        if not cands:
            return spec
        i = max(cands, key=lambda j: shape[j])
        parts = list(spec)
        parts[i] = fa[0] if len(fa) == 1 else fa
        return tuple(parts)

    def param_specs_tree(self, axes_tree, shapes_tree, *, fsdp: bool = True,
                         fsdp_axes: Sequence[str] = ("pod", "data")):
        """:meth:`param_spec` over an axes tree and a tree of leaves with
        the same structure (anything with a ``shape``)."""
        fa = tuple(fsdp_axes) if fsdp else ()
        if _is_names(axes_tree):
            return self.param_spec(axes_tree, tuple(shapes_tree.shape),
                                   fsdp_axes=fa)
        return {k: self.param_specs_tree(v, shapes_tree[k], fsdp=fsdp,
                                         fsdp_axes=fsdp_axes)
                for k, v in axes_tree.items()}

    # ---- this rank's place on the mesh (needs ``mesh``) ----
    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def index(self, axes) -> int:
        """This rank's block along ``axes``: mixed radix, the first axis
        major (the order ``PartitionSpec(("pod", "data"))`` deals)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.mesh.get_local_rank(a)
        return idx

    @property
    def fsdp_axes(self) -> tuple:
        """The data axes ZeRO-3 shards parameters over (empty below 3)."""
        return _axes(self.rules.get("fsdp"))


def current_rules() -> ShardingRules | None:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


# ---------------------------------------------------------------------------
# canonical rule sets
# ---------------------------------------------------------------------------

def hybrid_rules(shape: dict, *, fsdp: bool = True, mesh=None,
                 fsdp_axes: tuple | None = None) -> ShardingRules:
    """Whale's Case-2 hybrid, the reference's rule set: the batch over the
    data axes (pod-major), the tensor-parallel dims (heads, MLP columns,
    experts, vocab, SSM heads) over ``model``, the decode KV cache's
    sequence over ``model``, and under ZeRO-3 (``fsdp``) a parameter dim
    over the data axes (:meth:`ShardingRules.param_spec`).  ``shape`` is
    the mesh's {axis: size}; ``fsdp_axes`` narrows the data axes ZeRO-3
    shards over (default all of them).  The reference's context-parallel
    and expert-axis variants have no caller in the port."""
    data_axes = tuple(a for a in ("pod", "data") if a in shape)
    fa = data_axes if fsdp_axes is None else tuple(
        a for a in fsdp_axes if a in shape)
    rules = {
        "batch": (data_axes if len(data_axes) > 1
                  else (data_axes[0] if data_axes else None)),
        "seq": None,
        "embed": None,
        "q_heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "expert_mlp": "model",
        "vocab": "model",
        "ssm_heads": "model",
        "state": None,
        "conv": None,
        "layers": None,
        "q_seq": None,
        "kv_seq": ("model",),
        "fsdp": fa if fsdp else None,
    }
    return ShardingRules(shape=dict(shape), rules=rules, mesh=mesh)


def staged_specs(rules: ShardingRules, axes_tree, shapes_tree):
    """The specs of a pipeline's leaves (``repro/core/pipeline.py::
    staged_specs``): each leaf's spec from the rules (:meth:`ShardingRules.
    spec_for`, never the ZeRO-3 extension, so nothing is sharded over the
    data axes whatever the ZeRO stage), with the leading ``layers`` dim of
    a stacked leaf over ``stage``."""
    if _is_names(axes_tree):
        spec = rules.spec_for(axes_tree, tuple(shapes_tree.shape))
        if axes_tree and axes_tree[0] == "layers":
            return ("stage",) + spec[1:]
        return spec
    return {k: staged_specs(rules, v, shapes_tree[k])
            for k, v in axes_tree.items()}


def within_stage(specs):
    """Staged specs with the ``stage`` entry dropped: how a stage's rows of
    each leaf are cut over the other axes (a rank holds its own rows, so
    its block is cut from them, not from the padded whole)."""
    if isinstance(specs, dict):
        return {k: within_stage(v) for k, v in specs.items()}
    return tuple(None if e == "stage" else e for e in specs)


def rules_for_strategy(shape: dict, strat, mesh=None,
                       fsdp_axes: tuple | None = None) -> ShardingRules:
    """The plan's rules (``repro/core/planner.py::rules_for_strategy``):
    ZeRO-3 turns FSDP on (over ``fsdp_axes``, default every data axis);
    without ``vocab_split`` the vocab stays whole."""
    rules = hybrid_rules(shape, fsdp=strat.zero >= 3, mesh=mesh,
                         fsdp_axes=fsdp_axes)
    if not strat.vocab_split:
        rules.rules["vocab"] = None
    return rules


# ---------------------------------------------------------------------------
# what a model asks: is this logical dim split, and how
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """A logical dim split ``n`` ways over ``group``; this rank holds
    block ``index`` (elements ``[index·size/n, (index+1)·size/n)``)."""
    group: object
    n: int
    index: int


def split_of(name: str, size: int) -> Split | None:
    """How the active rules split logical dim ``name`` of ``size``
    elements: ``None`` with no rules, no mesh or where it stays whole
    (pruned, or over an axis of one).  Model code splits over one axis only."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return None
    (entry,) = rules.spec_for((name,), (size,))
    axes = _axes(entry)
    if rules.axis_size(axes) == 1:
        return None
    if len(axes) > 1:
        raise NotImplementedError(f"{name!r} split over {axes}: model code "
                                  f"splits over one axis")
    return Split(rules.group(axes[0]), rules.shape[axes[0]],
                 rules.index(axes))


def batch_splits() -> tuple:
    """The splits of the ``batch`` dim under the active rules, one per data
    axis of more than one rank, major first (empty with no rules or no
    mesh): the groups a statistic of the global batch is taken over."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return ()
    return tuple(Split(rules.group(a), rules.shape[a], rules.index(a))
                 for a in _axes(rules.rules.get("batch"))
                 if rules.shape.get(a, 1) > 1)


def fsdp_specs(model) -> dict | None:
    """``model``'s parameter specs under the active rules when they shard
    parameters over the data axes (ZeRO-3), else ``None``: the specs that
    say which dims a gather at use (:func:`gather_fsdp`) restores."""
    rules = current_rules()
    if rules is None or rules.mesh is None or not rules.fsdp_axes:
        return None
    return rules.param_specs_tree(model.axes(), model.param_shapes(),
                                  fsdp_axes=rules.fsdp_axes)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _via_host(group, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.detach().contiguous()
    if _via_host(group, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    if src.device == t.device:
        return torch.cat(parts, dim)
    # parts that crossed through host memory are laid into the result on
    # the device: no host copy of the whole
    size = src.shape[dim]
    shape = list(src.shape)
    shape[dim] = n * size
    out = torch.empty(shape, dtype=src.dtype, device=t.device)
    for i, part in enumerate(parts):
        out.narrow(dim, i * size, size).copy_(part)
    return out


def _scatter_sum(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``t``."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    r = dist.get_rank(group)
    if dist.get_backend(group) == "nccl":
        parts = [c.contiguous() for c in t.chunk(n, dim)]
        out = torch.empty_like(parts[r])
        dist.reduce_scatter(out, parts, group=group)
        return out
    full = t.contiguous().clone()
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full.chunk(n, dim)[r].contiguous()


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In place: ``t`` ← its sum over ``group``; returns ``t``."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max(t: torch.Tensor, split: Split) -> torch.Tensor:
    """The elementwise max of ``t`` over the split's group (a copy; no
    gradient flows through it)."""
    out = t.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=split.group)
    return out


class _CopyTo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanFrom(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, n):
        return all_reduce_(x.contiguous().clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherAlong(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        for grp in reversed(groups):          # minor axis first
            x = gather_cat(x, grp, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for grp in ctx.groups:                # major axis first
            g = _scatter_sum(g, grp, ctx.dim)
        return g, None, None


def copy_to(x: torch.Tensor, split: Split | None) -> torch.Tensor:
    """Identity forward, all-reduce over the split's group backward."""
    return x if split is None else _CopyTo.apply(x, split.group)


def reduce_from(x: torch.Tensor, split: Split | None) -> torch.Tensor:
    """All-reduce over the split's group forward, identity backward."""
    return x if split is None else _ReduceFrom.apply(x, split.group)


def mean_from(x: torch.Tensor, splits) -> torch.Tensor:
    """The mean of ``x`` over every split's group forward, identity
    backward.  A data-parallel step averages each rank's gradients over
    the data axes, so each rank hands the whole cotangent of the mean to
    its own ``x``: the average of the ranks' gradients is then the
    gradient of a loss of the global mean."""
    for split in splits:
        x = _MeanFrom.apply(x, split.group, split.n)
    return x


def gather_along(x: torch.Tensor, dim: int, groups: list) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` over ``groups`` (the axes' groups,
    major first) gathered; the backward sums the gradient over them and
    keeps this rank's block (a reduce-scatter)."""
    return _GatherAlong.apply(x, dim, tuple(groups))


# ---------------------------------------------------------------------------
# leaves by spec
# ---------------------------------------------------------------------------

def shard_leaf(full: torch.Tensor, spec: tuple,
               rules: ShardingRules) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a contiguous copy)."""
    out = full
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = rules.axis_size(entry)
        size = out.shape[dim] // n
        out = out.narrow(dim, rules.index(entry) * size, size)
    return out.contiguous().clone() if out is not full else full


def gather_leaf(local: torch.Tensor, spec: tuple,
                rules: ShardingRules) -> torch.Tensor:
    """The full leaf from every rank's block under ``spec`` (collective
    over each sharded dim's axes; no gradient)."""
    out = local
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            out = gather_cat(out, rules.group(a), dim)
    return out


def gather_fsdp(tree: dict, specs: dict, rules: ShardingRules,
                lead: int = 0) -> dict:
    """``tree`` with every dim sharded over the ZeRO-3 data axes gathered
    through :func:`gather_along` (the model axis stays split).  ``lead``
    drops that many leading dims of each spec (a repeat's slice of the
    stacked ``layers`` leaves)."""
    fa = set(rules.fsdp_axes)
    paths, leaves = flatten(tree)
    spec_leaves = flatten(specs)[1]
    out = []
    for x, spec in zip(leaves, spec_leaves):
        for dim, entry in enumerate(spec[lead:]):
            axes = _axes(entry)
            if axes and set(axes) <= fa:
                x = gather_along(x, dim, [rules.group(a) for a in axes])
        out.append(x)
    return unflatten(paths, out)


@dataclasses.dataclass(frozen=True)
class Slice:
    """A leaf's ZeRO-1 slice: this rank's block ``index`` of ``n`` along
    ``dim`` over the data ``axes`` (the optimizer state's extra split
    beyond the parameter's)."""
    dim: int
    axes: tuple
    n: int
    index: int
    rules: ShardingRules

    def narrow(self, t: torch.Tensor) -> torch.Tensor:
        size = t.shape[self.dim] // self.n
        return t.narrow(self.dim, self.index * size, size)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        for a in reversed(self.axes):
            t = gather_cat(t, self.rules.group(a), self.dim)
        return t


def zero_slices(param_specs: dict, opt_specs: dict,
                rules: ShardingRules) -> dict:
    """Per parameter leaf, the :class:`Slice` its optimizer state takes
    beyond the parameter's own spec (ZeRO-1/2), or ``None``."""
    paths, pspecs = flatten(param_specs)
    ospecs = flatten(opt_specs)[1]
    out = []
    for ps, os_ in zip(pspecs, ospecs):
        extra = [(d, _axes(o)) for d, (p, o) in enumerate(zip(ps, os_))
                 if p != o]
        if not extra:
            out.append(None)
            continue
        (dim, axes), = extra
        out.append(Slice(dim, axes, rules.axis_size(axes),
                         rules.index(axes), rules))
    return unflatten(paths, out)
