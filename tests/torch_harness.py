"""Shared inputs and tolerances for the port's tests (tests/test_torch_*).

Tolerances follow the reference's policy (tests/kernel_harness.py): f32
2e-5, bf16 2e-2, as allclose with atol = rtol = tol.  Inputs are made with
numpy from a seed, so the JAX reference and the port see the same values.
Imports neither JAX nor the reference package, so the GPU tests can run
on a machine that has only PyTorch.
"""
from __future__ import annotations

import numpy as np

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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
