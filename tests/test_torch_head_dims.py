"""The flash and paged-decode ops at the head dims the rest of the dense
family brings, 80 (stablelm-3b) and 256 (gemma-2b), against the
reference's Pallas kernels in interpret mode on the CPU: the port's
plain versions (what the CPU runs, and what the card holds each CUDA
kernel against) with groups 1, 2 and 8.

- the differentiable flash op's values and VJP, f32 and bf16, against the
  reference's ``ops.flash`` and its ``attention_ref`` oracle;
- the plain backward from the same (q, k, v, do, lse, δ) against the
  reference's fused backward, f32;
- paged decode against the reference's ``paged_decode``, f32 and bf16,
  with an inactive slot;
- the wrappers take the new dims (the ``gpu``-marked tests in
  tests/test_torch_gpu.py launch the kernels at them on the card).

Tolerances (tests/torch_harness.py): values f32 2e-5 / bf16 2e-2,
gradients f32 2e-4 / bf16 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_flash_ops
from repro.kernels.flash_attention.flash import (
    flash_attention as jax_flash_fwd, flash_attention_bwd as jax_flash_bwd)
from repro.kernels.flash_attention.paged import paged_decode as jax_paged
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import flash, paged
from repro_torch.kernels.flash_attention.ops import flash as flash_op

from torch_harness import (TOL, TOLS, check_vjp, close, cotangents,
                           np_inputs, paged_inputs)

#: (B, Sq, Sk, H, K, D, causal): groups 1, 2 and 8 at each new dim
FLASH_CASES = [
    (1, 64, 64, 4, 4, 80, True),        # stablelm: MHA
    (2, 64, 64, 4, 2, 80, True),        # group 2
    (1, 64, 64, 8, 1, 80, True),        # group 8
    (1, 64, 64, 8, 1, 256, True),       # gemma: MQA, group 8
    (1, 64, 64, 4, 4, 256, True),       # MHA
    (1, 32, 64, 4, 2, 256, False),      # cross shape, group 2
]


def _jax_value_and_vjp(fn, args, *, diff_argnums, dtype, cts):
    jargs = [jnp.asarray(a, dtype) for a in args]

    def f(*diff):
        full = list(jargs)
        for i, d in zip(diff_argnums, diff):
            full[i] = d
        out = fn(*full)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    outs, vjp = jax.vjp(f, *(jargs[i] for i in diff_argnums))
    grads = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cts, outs)))
    return ([np.asarray(o, np.float32) for o in outs],
            [np.asarray(g, np.float32) for g in grads])


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_op_values_and_vjps_match_reference(B, Sq, Sk, H, K, D, causal,
                                                  dtype):
    args = np_inputs((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D), seed=D + H)
    cts = cotangents([(B, Sq, H, D)], seed=K)
    kw = dict(diff_argnums=(0, 1, 2), dtype=dtype, cts=cts)
    port = lambda q, k, v: flash_op(q, k, v, causal, False)
    want_kernel = _jax_value_and_vjp(
        lambda q, k, v: jax_flash_ops.flash(q, k, v, causal, 32, 32, True,
                                            False), args, **kw)
    want_oracle = _jax_value_and_vjp(
        lambda q, k, v: attention_ref(q, k, v, causal=causal), args, **kw)
    check_vjp(port, args, want_kernel, msg="vs reference flash", **kw)
    check_vjp(port, args, want_oracle, msg="vs attention_ref", **kw)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal", FLASH_CASES)
def test_flash_bwd_plain_matches_reference_bwd(B, Sq, Sk, H, K, D, causal):
    q, k, v, do = np_inputs((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D),
                            (B, Sq, H, D), seed=D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jax_flash_fwd(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                           interpret=True, return_lse=True)
    delta = jnp.sum(jdo * o, axis=-1).reshape(B, Sq, K, H // K)
    want = jax_flash_bwd(jq, jk, jv, jdo, lse, delta, causal=causal,
                         block_q=32, block_k=32, interpret=True)
    t = lambda a: torch.tensor(np.asarray(a))
    got = flash.flash_attention_bwd(t(q), t(k), t(v), t(do), t(lse),
                                    t(delta), causal)
    for g, w in zip(got, want):
        close(g, w, TOLS["float32"].grad)


@pytest.mark.parametrize("B,H,K,D,ps,mp", [
    (3, 4, 4, 80, 4, 3),       # stablelm: MHA
    (3, 4, 2, 80, 4, 3),       # group 2
    (2, 8, 1, 80, 8, 3),       # group 8
    (2, 8, 1, 256, 4, 3),      # gemma: MQA, group 8
    (2, 4, 2, 256, 8, 2),      # group 2
    (2, 4, 4, 256, 4, 3),      # MHA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_reference(B, H, K, D, ps, mp, dtype):
    P = 1 + B * mp
    q, kp, vp, table, pos = paged_inputs(B, H, K, D, ps, mp, P, seed=D + K)
    want = jax_paged(*(jnp.asarray(a, dtype) for a in (q, kp, vp)),
                     jnp.asarray(table), jnp.asarray(pos), interpret=True)
    tdt = getattr(torch, dtype)
    got = paged.paged_decode(*(torch.tensor(a).to(tdt) for a in (q, kp, vp)),
                             torch.tensor(table), torch.tensor(pos))
    assert got.dtype == tdt and got.shape == (B, H, D)
    assert torch.isfinite(got[-1]).all()               # inactive slot
    close(got.float(), want, TOL[dtype])


def test_wrappers_take_the_new_dims():
    """The CUDA wrappers' head dims (the kernels are built for these and
    return an error for any other) and paged decode's groups."""
    assert set(flash.HEAD_DIMS) == set(paged.HEAD_DIMS) == {64, 80, 128, 256}
    assert {1, 2, 8} <= set(paged.GROUPS)
