"""Optimizers over nested dicts of tensors: the reference's interface
(``repro/optim/optimizer.py``) without its sharding axes::

    opt = adamw(lr=Schedule(...))
    state = opt.init(params)
    params, state = opt.apply(grads, state, params, step)

``apply`` updates ``params`` and ``state`` in place (under ``no_grad``) and
returns them, which saves a copy of every parameter and moment per step.
Where ``grads`` is one part of the model's gradient (a pipeline stage's
leaves, a rank's shards of a split model), ``grad_norm`` is the whole
gradient's global norm, so every part is clipped by the same factor; by
default it is the norm of ``grads`` (:func:`sharded_global_norm` sums a
split model's squares over its shards).  The clip's factor is folded into
each leaf's update as it reads the leaf (the reference's clipped leaf,
rounded to the gradient's dtype), so no clipped copy of the gradient is
made.

ZeRO-1/2: ``init`` takes the parameters as this rank's slices
(``Slice.narrow`` of each leaf the plan's ZeRO specs shard further), so
the state is the slices'; ``apply(..., slices=)`` updates each such leaf
on its slice and all-gathers the updated slice into the whole parameter
over the data axes.  AdamW is elementwise, so its parameters equal an
unsliced run's bit for bit.

Adafactor's means (``g²`` over the last and the next-to-last dim, ``vr``
over its last, the update clip's ``mean(u²)`` over the leaf) are the
reference's over the whole leaf, which GSPMD computes whatever the
sharding.  Where a rank holds a block of the leaf (``specs``, ``rules``:
its spec over the model axis, ZeRO-3's data shards, a pipeline stage's
rows; ``slices``: a ZeRO-1/2 slice), each mean is a sum over the block,
all-reduced over every axis that cuts the dims it averages, over the
whole leaf's count (``shapes``, the model's; a sum of shards is not
bit-equal to one whole mean: within f32's rounding).  Every optimizer
takes these keywords; AdamW and SGD, elementwise, ignore them.  The
update takes a leaf whole where its f32 temporaries fit in the card's
free memory, else in chunks of at most :data:`ADAFACTOR_CHUNK` elements
over the leading (layer, expert) dims, and over rows within one matrix
above that: ``vr``, ``vc`` and ``vr``'s mean are exact per chunk, and the
clip's ``Σ u²`` is summed over the chunks before any chunk is written,
each chunk's ``u`` recomputed then, so no temporary outgrows a chunk.
Taken whole, the leaf's clipped gradient serves both ``g²`` and ``u``,
and the update is one ``addcdiv_`` into the parameter.
The numbers are the reference's: bias corrections with ``t = step + 1``
and ``lr = sched(step)`` in f32, every update computed in f32 and written
back in the leaf's dtype, clipping by the global norm first (Adafactor's
fused ``addcmul`` and ``addcdiv_`` may round an ulp from its separate
ops).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.tree import flatten, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the most elements of a leaf Adafactor updates at once where the leaf's
#: temporaries do not fit (256 MiB of f32: one of grok-1's expert leaves
#: is 1.61e9 elements, and each of the update's eager f32 temporaries
#: would be the leaf's size)
ADAFACTOR_CHUNK = 1 << 26
#: the leaf-sized f32 temporaries a whole-leaf update needs room for (it
#: holds at most three at once: the clipped gradient, g² or u, and the
#: allocator's rounding; the rest is margin for ranks sharing a card)
_WHOLE_LEAF_TEMPS = 8


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Linear warm-up, then cosine decay to ``min_ratio``; evaluated in f32
    as the reference's jnp schedule is."""
    base_lr: float = 3e-4
    warmup: int = 100
    decay_steps: int = 10000
    min_ratio: float = 0.1

    def __call__(self, step) -> float:
        f = np.float32
        step = f(step)
        warm = min(step / f(max(self.warmup, 1)), f(1.0))
        frac = np.clip((step - f(self.warmup))
                       / f(max(self.decay_steps - self.warmup, 1)),
                       f(0), f(1))
        cos = f(0.5) * (f(1) + np.cos(f(math.pi) * frac, dtype=f))
        lr = (f(self.base_lr) * warm
              * (f(self.min_ratio) + f(1 - self.min_ratio) * cos))
        return float(f(lr))


def _sched(lr) -> Callable:
    if callable(lr):
        return lr
    return lambda step: float(np.float32(lr))


def _sum_sq(g: torch.Tensor, chunk: int = 1 << 22) -> torch.Tensor:
    """Σ g² of one leaf, the squares in f32 summed in f64, ``chunk``
    elements at a time: the f64 sum takes an f64 copy of what it sums,
    beside the f32 squares, so a chunk costs 12 bytes an element (10.5 GiB
    for one of jamba's expert leaves taken whole; 48 MiB a chunk, below
    a pipeline stage's activations)."""
    return sum((torch.sum(c.float().square(), dtype=torch.float64)
                for c in g.reshape(-1).split(chunk)),
               torch.zeros((), dtype=torch.float64, device=g.device))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, a 0-d f32 tensor; the squares are summed
    in f64, as :func:`sharded_global_norm` sums them, so a ZeRO run (whose
    leaves may be cut) clips as the same run without ZeRO does."""
    leaves = flatten(tree)[1]
    return torch.sqrt(sum(_sum_sq(g) for g in leaves)).float()


def sharded_global_norm(grads, specs, rules) -> torch.Tensor:
    """The global norm of a gradient split by ``specs`` (a tree of specs
    matching ``grads``): each leaf's Σ g² summed over the axes its spec
    shards, a replicated leaf counted once; the same on every rank.  The
    squares are summed in f64, so the f32 norm does not depend on how the
    leaves are cut (ZeRO-3's data shards clip as ZeRO-0's whole leaves
    do)."""
    from repro_torch.core import sharding

    by_axes: dict = {}
    for g, spec in zip(flatten(grads)[1], flatten(specs)[1]):
        axes = tuple(sorted({a for p in spec for a in sharding._axes(p)}))
        sq = _sum_sq(g)
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = None
    for axes in sorted(by_axes):
        sq = by_axes[axes]
        for a in axes:
            if rules.shape[a] > 1:
                sharding.all_reduce_(sq, rules.group(a))
        total = sq if total is None else total + sq
    return torch.sqrt(total).float()


def clip_scale(grads, max_norm: float, norm=None) -> tuple:
    """(min(1, max_norm / norm), norm), each a 0-d f32 tensor; ``norm``
    defaults to :func:`global_norm` of ``grads``."""
    if norm is None:
        norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """(grads scaled by min(1, max_norm / norm), norm); ``norm`` defaults
    to :func:`global_norm` of ``grads``.  The optimizers fold the same
    factor into each leaf instead (:func:`_clipped`)."""
    scale, norm = clip_scale(grads, max_norm, norm)
    return tree_map(lambda g: _clipped(g, scale).to(g.dtype), grads), norm


def _clipped(g: torch.Tensor, scale) -> torch.Tensor:
    """``g`` (or a chunk of it) clipped, in f32: the reference's clipped
    leaf ``(g·scale)`` rounded to ``g``'s dtype, as its update reads it."""
    if scale is None:
        return g.float()
    return (g.float() * scale).to(g.dtype).float()


@dataclasses.dataclass(frozen=True)
class _Cut:
    """How the block a rank updates is cut from the whole leaf: per dim,
    the process groups that split it; the whole leaf's shape."""
    groups: tuple
    whole: tuple

    def sum_over(self, t: torch.Tensor, dims) -> torch.Tensor:
        """``t`` (a partial sum over this block's ``dims``) summed in
        place over every group that cuts one of them."""
        from repro_torch.core import sharding

        for d in dims:
            for grp in self.groups[d]:
                sharding.all_reduce_(t, grp)
        return t

    def count(self, dims) -> int:
        return math.prod(self.whole[d] for d in dims)


def _cuts(leaves: list, specs, rules, slices, shapes) -> list:
    """Each leaf's :class:`_Cut`: the groups of the axes its spec
    (``specs``, a tree like the leaves', under ``rules``) and its ZeRO-1/2
    slice cut each dim over, and the whole leaf's shape (``shapes``, the
    model's; the leaf's own where there are none)."""
    from repro_torch.core import sharding

    if specs is not None and shapes is None:
        raise ValueError("a block's means need shapes=, the whole leaves'")
    n = len(leaves)
    spec_l = flatten(specs)[1] if specs is not None else [()] * n
    slice_l = flatten(slices)[1] if slices is not None else [None] * n
    whole_l = flatten(shapes)[1] if shapes is not None else leaves
    out = []
    for p, spec, cut, whole in zip(leaves, spec_l, slice_l, whole_l):
        groups = [[] for _ in range(p.dim())]
        for d, entry in enumerate(spec):
            groups[d] += [rules.group(a) for a in sharding._axes(entry)
                          if rules.shape.get(a, 1) > 1]
        if cut is not None:
            groups[cut.dim] += [cut.rules.group(a) for a in cut.axes
                                if cut.rules.shape.get(a, 1) > 1]
        out.append(_Cut(tuple(map(tuple, groups)), tuple(whole.shape)))
    return out


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    # (grads, state, params, step, *, grad_norm=None, slices=None,
    #  specs=None, rules=None, shapes=None) -> (params, state); the last
    #  three lay out the blocks a rank holds (module docstring)
    apply: Callable
    name: str = "opt"
    # param axes -> the state's axes tree, for the planner's ZeRO specs
    state_axes: Callable | None = None


def _pairs(*trees) -> list:
    """The leaves of trees that share one structure, zipped."""
    return list(zip(*(flatten(t)[1] for t in trees)))


def adamw(lr: Schedule | float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          moment_dtype: str = "float32",
          max_grad_norm: float = 1.0) -> Optimizer:
    sched = _sched(lr)
    mdt = _DTYPES[moment_dtype]

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def apply(grads, state, params, step, *, grad_norm=None, slices=None,
              specs=None, rules=None, shapes=None):
        scale = (clip_scale(grads, max_grad_norm, grad_norm)[0]
                 if max_grad_norm else None)
        t = np.float32(step) + np.float32(1)
        lr_t = sched(step)
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
        sl = (flatten(slices)[1] if slices is not None
              else [None] * len(flatten(params)[1]))
        for (g, mu, nu, p), cut in zip(
                _pairs(grads, state["mu"], state["nu"], params), sl):
            mine = p if cut is None else cut.narrow(p)
            g = _clipped(g if cut is None else cut.narrow(g), scale)
            mu_n = b1 * mu.float() + (1 - b1) * g
            nu_n = b2 * nu.float() + (1 - b2) * g * g
            u = (mu_n / c1) / (torch.sqrt(nu_n / c2) + eps)
            if weight_decay:
                u = u + weight_decay * mine.float()
            new = mine.float() - lr_t * u
            p.copy_(new if cut is None else cut.gather(new.to(p.dtype)))
            mu.copy_(mu_n)
            nu.copy_(nu_n)
        return params, state

    def state_axes(param_axes):
        return {"mu": param_axes, "nu": param_axes}

    return Optimizer(init=init, apply=apply, name="adamw",
                     state_axes=state_axes)


def adafactor(lr: Schedule | float = 3e-4, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              max_grad_norm: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern): O(N/d) state,
    factored over the last two dims of every leaf with two or more.  Its
    means are the whole leaf's wherever a rank holds a block of it, and
    its temporaries are at most :data:`ADAFACTOR_CHUNK` elements (module
    docstring)."""
    sched = _sched(lr)

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.dim() >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"v": tree_map(one, params)}

    def factored(g, v, p, cut, scale, beta2, lr_t, free):
        R, C = g.shape[-2:]
        N = g.numel() // max(R * C, 1)
        gv = g.reshape(N, R, C)
        pv = p if p.is_contiguous() else p.contiguous()
        pw = pv.view(N, R, C)
        vr, vc = v["vr"].view(N, R), v["vc"].view(N, C)
        pieces = _pieces(N, R, C, _chunk_for(g.numel(), free))
        nd = g.dim()
        # pass 1: Σ g² over each row and column, summed over the blocks;
        # one chunk keeps its clipped gradient for u
        keep = len(pieces) == 1
        rows = torch.empty((N, R), dtype=torch.float32, device=g.device)
        cols = torch.zeros((N, C), dtype=torch.float32, device=g.device)
        eps_t = torch.full((), eps, dtype=torch.float32, device=g.device)
        gp = None
        for ls, rs in pieces:
            gp = _clipped(gv[ls, rs], scale)        # may be the gradient
            g2 = torch.addcmul(eps_t, gp, gp)
            rows[ls, rs] = g2.sum(-1)
            cols[ls] += g2.sum(-2)
            del g2
        if not keep:
            gp = None
        cut.sum_over(rows, (nd - 1,))
        cut.sum_over(cols, (nd - 2,))
        vr.copy_(beta2 * vr + (1 - beta2) * (rows / cut.count((nd - 1,))))
        vc.copy_(beta2 * vc + (1 - beta2) * (cols / cut.count((nd - 2,))))
        del rows, cols
        mean_r = cut.sum_over(vr.sum(-1), (nd - 2,)) / cut.count((nd - 2,))
        den = torch.clamp(mean_r, min=eps)

        def u_of(ls, rs, gp=None):
            u = vr[ls, rs, None] * vc[ls, None, :]
            u.div_(den[ls, None, None]).add_(eps).rsqrt_()
            return u.mul_(_clipped(gv[ls, rs], scale) if gp is None else gp)

        # pass 2: the clip's Σ u² over the whole leaf; pass 3: the update
        # (one chunk keeps its u between them)
        us = [u_of(*pieces[0], gp)] if keep else None
        gp = None
        div = None
        if clip_threshold:
            usq = torch.zeros((), dtype=torch.float64, device=g.device)
            for ls, rs in pieces:
                u = us[0] if keep else u_of(ls, rs)
                usq += torch.linalg.vector_norm(u).double().square()
                del u
            div = _clip_div(cut, usq, clip_threshold)
        for ls, rs in pieces:
            u = us[0] if keep else u_of(ls, rs)
            blk = pw[ls, rs]
            new = blk if blk.dtype == torch.float32 else blk.float()
            if div is None:
                new.add_(u, alpha=-lr_t)
            else:
                new.addcdiv_(u, div, value=-lr_t)
            if new is not blk:
                blk.copy_(new)
            del u, new
        if pv is not p:
            p.copy_(pv)

    def unfactored(g, v, p, cut, scale, beta2, lr_t, free):
        g = _clipped(g, scale)
        vv = beta2 * v["v"] + (1 - beta2) * (g * g + eps)
        u = g * torch.rsqrt(vv + eps)
        v["v"].copy_(vv)
        if clip_threshold:
            u = u / _clip_div(cut, torch.sum(u * u).double(),
                              clip_threshold)
        p.copy_(p.float() - lr_t * u)

    @torch.no_grad()
    def apply(grads, state, params, step, *, grad_norm=None, slices=None,
              specs=None, rules=None, shapes=None):
        scale = (clip_scale(grads, max_grad_norm, grad_norm)[0]
                 if max_grad_norm else None)
        t = np.float32(step) + np.float32(1)
        beta2 = float(np.float32(1) - t ** np.float32(-decay))
        lr_t = sched(step)
        gl, pl = flatten(grads)[1], flatten(params)[1]
        sl = (flatten(slices)[1] if slices is not None
              else [None] * len(pl))
        cuts = _cuts(pl, specs, rules, slices, shapes)
        free = _free_bytes(pl[0].device) if pl else None
        for g, v, p, cut, piece in zip(gl, _v_leaves(state["v"]), pl, cuts,
                                       sl):
            mine = p if piece is None else piece.narrow(p)
            if piece is not None:
                g = piece.narrow(g)
            upd = factored if "vr" in v else unfactored
            upd(g, v, mine, cut, scale, beta2, lr_t, free)
            if piece is not None:
                p.copy_(piece.gather(mine))
        return params, state

    def state_axes(param_axes):
        def one(names):
            if len(names) >= 2:
                return {"vr": names[:-1], "vc": names[:-2] + names[-1:]}
            return {"v": names}
        return {"v": tree_map(one, param_axes)}

    return Optimizer(init=init, apply=apply, name="adafactor",
                     state_axes=state_axes)


def _free_bytes(device) -> int | None:
    """The card's free memory, CUDA's and the allocator's cache (read
    once a step: a leaf's temporaries are freed before the next); ``None``
    on the CPU."""
    if device.type != "cuda":
        return None
    return (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def _chunk_for(numel: int, free: int | None) -> int:
    """The most elements of a leaf of ``numel`` Adafactor updates at once:
    the whole leaf where :data:`_WHOLE_LEAF_TEMPS` f32 copies of it fit in
    ``free`` bytes (:func:`_free_bytes`), so its u is computed once; else
    :data:`ADAFACTOR_CHUNK` (always on the CPU)."""
    if free is not None and 4 * _WHOLE_LEAF_TEMPS * numel <= free:
        return max(numel, 1)
    return ADAFACTOR_CHUNK


def _pieces(N: int, R: int, C: int, chunk: int) -> list:
    """The chunks of a stack of ``N`` (R, C) matrices that Adafactor
    updates one at a time, as (matrix slice, row slice) pairs of at most
    ``chunk`` elements where a row fits: whole matrices while they fit,
    else blocks of rows of one matrix."""
    per = max(R * C, 1)
    if per <= chunk:
        k = max(1, chunk // per)
        return [(slice(i, min(i + k, N)), slice(0, R))
                for i in range(0, N, k)]
    rb = max(1, chunk // max(C, 1))
    return [(slice(i, i + 1), slice(r, min(r + rb, R)))
            for i in range(N) for r in range(0, R, rb)]


def _clip_div(cut: _Cut, usq: torch.Tensor, threshold: float):
    """max(1, rms(u) / threshold): ``usq`` (this block's Σ u², f64) summed
    over every group that cuts the leaf, over the whole leaf's count."""
    cut.sum_over(usq, range(len(cut.whole)))
    un = torch.sqrt(usq / cut.count(range(len(cut.whole)))).float()
    return torch.clamp(un / threshold, min=1.0)


def _v_leaves(tree) -> list:
    """Adafactor's per-parameter state dicts ({"vr", "vc"} or {"v"}) in
    the parameters' sorted leaf order."""
    if set(tree) <= {"vr", "vc", "v"} and all(
            isinstance(x, torch.Tensor) for x in tree.values()):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in _v_leaves(tree[k])]


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def apply(grads, state, params, step, *, grad_norm=None, slices=None,
              specs=None, rules=None, shapes=None):
        for g, p in _pairs(grads, params):
            p.copy_(p.float() - lr * g.float())
        return params, state

    return Optimizer(init=init, apply=apply, name="sgd",
                     state_axes=lambda param_axes: {})


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](**kw)
