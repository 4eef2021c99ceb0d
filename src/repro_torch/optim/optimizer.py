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
split model's squares over its shards).

ZeRO-1/2 (AdamW): ``init`` takes the parameters as this rank's slices
(``Slice.narrow`` of each leaf the plan's optimizer specs shard further),
so ``mu``/``nu`` are slices; ``apply(..., slices=)`` updates each such
leaf elementwise on its slice and all-gathers the updated slice into the
whole parameter over the data axes, so the parameters equal an unsliced
run's bit for bit.
The numbers are the reference's: bias corrections with ``t = step + 1``
and ``lr = sched(step)`` in f32, every update computed in f32 and written
back in the leaf's dtype, clipping by the global norm first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.tree import flatten, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """(grads scaled by min(1, max_norm / norm), norm); ``norm`` defaults
    to :func:`global_norm` of ``grads``."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    # (grads, state, params, step, *, grad_norm=None, slices=None)
    #   -> (params, state)
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
    def apply(grads, state, params, step, *, grad_norm=None, slices=None):
        if max_grad_norm:
            grads, _ = clip_by_global_norm(grads, max_grad_norm, grad_norm)
        t = np.float32(step) + np.float32(1)
        lr_t = sched(step)
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
        sl = (flatten(slices)[1] if slices is not None
              else [None] * len(flatten(params)[1]))
        for (g, mu, nu, p), cut in zip(
                _pairs(grads, state["mu"], state["nu"], params), sl):
            mine = p if cut is None else cut.narrow(p)
            g = (g if cut is None else cut.narrow(g)).float()
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
    factored over the last two dims of every leaf with two or more."""
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

    @torch.no_grad()
    def apply(grads, state, params, step, *, grad_norm=None, slices=None):
        if slices is not None:
            raise NotImplementedError("ZeRO slices of adafactor's factored "
                                      "moments are not ported")
        if max_grad_norm:
            grads, _ = clip_by_global_norm(grads, max_grad_norm, grad_norm)
        t = np.float32(step) + np.float32(1)
        beta2 = float(np.float32(1) - t ** np.float32(-decay))
        lr_t = sched(step)
        gl, pl = flatten(grads)[1], flatten(params)[1]
        for g, v, p in zip(gl, _v_leaves(state["v"]), pl):
            g = g.float()
            g2 = g * g + eps
            if "vr" in v:
                vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(-1)
                vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(-2)
                rms = (vr[..., None] * vc[..., None, :]
                       / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
                u = g * torch.rsqrt(rms + eps)
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                vv = beta2 * v["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(vv + eps)
                v["v"].copy_(vv)
            if clip_threshold:
                un = torch.sqrt(torch.mean(u * u))
                u = u / torch.clamp(un / clip_threshold, min=1.0)
            p.copy_(p.float() - lr_t * u)
        return params, state

    def state_axes(param_axes):
        def one(names):
            if len(names) >= 2:
                return {"vr": names[:-1], "vc": names[:-2] + names[-1:]}
            return {"v": names}
        return {"v": tree_map(one, param_axes)}

    return Optimizer(init=init, apply=apply, name="adafactor",
                     state_axes=state_axes)


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
    def apply(grads, state, params, step, *, grad_norm=None, slices=None):
        for g, p in _pairs(grads, params):
            p.copy_(p.float() - lr * g.float())
        return params, state

    return Optimizer(init=init, apply=apply, name="sgd",
                     state_axes=lambda param_axes: {})


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](**kw)
