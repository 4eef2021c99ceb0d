"""Shared inputs, tolerances and value-and-VJP checks for the port's tests
(tests/test_torch_*).

Tolerances follow the reference's policy (tests/kernel_harness.py), as
allclose with atol = rtol = tol: values f32 2e-5, bf16 2e-2; gradients
get 10x headroom in f32 (2e-4) and 5e-2 in bf16, because a backward
recomputes ``p = exp(s - lse)`` instead of reusing the forward's factors.
Inputs and cotangents are made with numpy from a seed, so the JAX
reference and the port see the same values.  Imports neither JAX nor the
reference package, so the GPU tests can run on a machine that has only
PyTorch; the JAX half of a gradient check (``jax.vjp`` with the same
cotangents) lives in the test files.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import calibrate, cost_model

@dataclasses.dataclass(frozen=True)
class Tol:
    fwd: float
    grad: float


TOLS = {"float32": Tol(fwd=2e-5, grad=2e-4),
        "bfloat16": Tol(fwd=2e-2, grad=5e-2)}
TOL = {dtype: tol.fwd for dtype, tol in TOLS.items()}    # values only


def np_inputs(*shapes, seed=0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def close(got, want, tol: float) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def paged_inputs(B, H, K, D, ps, mp, P, seed=0):
    """q (B,H,D), pools (P,ps,K,D) with an all-zero trash page 0, a block
    table of distinct physical pages covering each slot's ragged ``pos``,
    and an inactive last slot (table row 0, pos 0)."""
    q, kp, vp = np_inputs((B, H, D), (P, ps, K, D), (P, ps, K, D),
                          seed=seed)
    kp[0] = vp[0] = 0
    rng = np.random.default_rng(seed + 1)
    pos = rng.integers(0, mp * ps, B).astype(np.int32)
    pos[-1] = 0
    table = np.zeros((B, mp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B - 1):
        n = pos[b] // ps + 1
        table[b, :n] = [free.pop() for _ in range(n)]
    return q, kp, vp, table, pos


def cotangents(shapes, seed: int = 0) -> list:
    """One random f32 cotangent per output shape."""
    rng = np.random.default_rng(10_000 + seed)
    return [rng.standard_normal(tuple(s)).astype(np.float32) for s in shapes]


def torch_args(args, dtype: str, diff_argnums=(), device="cpu") -> list:
    """numpy args → tensors: float arrays in ``dtype`` (those at
    ``diff_argnums`` requiring grad), integer arrays as they are."""
    out = []
    for i, a in enumerate(args):
        t = torch.tensor(a, device=device)
        if t.is_floating_point():
            t = t.to(getattr(torch, dtype))
            t.requires_grad_(i in diff_argnums)
        out.append(t)
    return out


def value_and_vjp(fn, args, *, diff_argnums, dtype: str, cts,
                  device="cpu") -> tuple:
    """(outputs, grads) of ``fn`` as f32 numpy: the outputs of
    ``fn(*args)`` and the gradient of Σ vdot(output_i, ct_i) with respect
    to each arg in ``diff_argnums`` — the full VJP for a random cotangent,
    driven through ``torch.autograd.grad``."""
    targs = torch_args(args, dtype, diff_argnums, device)
    outs = fn(*targs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    scalar = sum(torch.sum(o.float() * torch.tensor(ct, device=device))
                 for o, ct in zip(outs, cts))
    grads = torch.autograd.grad(scalar, [targs[i] for i in diff_argnums])
    return ([o.detach().float().cpu().numpy() for o in outs],
            [g.float().cpu().numpy() for g in grads])


def check_vjp(fn, args, want, *, diff_argnums, dtype: str, cts,
              device="cpu", msg: str = "") -> None:
    """``fn``'s outputs and VJP (:func:`value_and_vjp`) against ``want`` =
    (outputs, grads), within :data:`TOLS` for ``dtype``."""
    tol = TOLS[dtype]
    outs, grads = value_and_vjp(fn, args, diff_argnums=diff_argnums,
                                dtype=dtype, cts=cts, device=device)
    for i, (g, w) in enumerate(zip(outs, want[0])):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   atol=tol.fwd, rtol=tol.fwd,
                                   err_msg=f"{msg} output {i}")
    for pos, g, w in zip(diff_argnums, grads, want[1]):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   atol=tol.grad, rtol=tol.grad,
                                   err_msg=f"{msg} grad(arg{pos})")


# ---------------------------------------------------------------------------
# planning: the reference's dataclasses carried across as data
# ---------------------------------------------------------------------------

PORT_CLASSES = {c.__name__: c for c in (
    cost_model.Hardware, cost_model.DeviceGroup, cost_model.ClusterSpec,
    cost_model.StrategySpec, cost_model.WorkloadMeta, cost_model.SegmentMeta,
    cost_model.ModelGraph, cost_model.ServingMeta, calibrate.Observation,
    calibrate.CalibratedHardware)}


def to_port(x):
    """A reference object (a planning dataclass, or a tuple/list/dict of
    them) rebuilt field by field as the port's class of the same name —
    the two packages' planning types carried across as data."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = PORT_CLASSES[type(x).__name__]
        return cls(**{f.name: to_port(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(to_port(v) for v in x)
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    return x


def data(x):
    """A planning result as plain data (dataclasses → dicts, recursively)
    for exact (``==``) comparison across the two packages."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: data(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return type(x)(data(v) for v in x)
    if isinstance(x, dict):
        return {k: data(v) for k, v in x.items()}
    return x


def outcome(fn, *args, **kw):
    """``("ok", data(result))`` or ``("raised", type name, message)``, so
    a call and its error path are compared alike."""
    try:
        return ("ok", data(fn(*args, **kw)))
    except (ValueError, RuntimeError, KeyError, ArithmeticError) as e:
        return ("raised", type(e).__name__, str(e))
