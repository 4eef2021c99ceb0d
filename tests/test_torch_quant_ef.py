"""The gradient compressor's fused error-feedback encode
(``repro_torch.kernels.quant.quant.ef_absmax``, ``ef_requant``,
``ef_decode``) on the CPU, where each wrapper runs its plain version.

The three plain versions are slices of ``compressed_psum_plain``'s op by op
body; composed around the two collectives they must give its numbers bit
for bit: the reduced gradient, the new error, and (through the scale) the
int8 values.  ``compressed_psum``, which runs the three wrappers, must give
them too.  A group of ranks is simulated in one process: each rank is a
thread with its own inputs made with numpy from a seed, and the
collectives are a barrier and a stack (:class:`ThreadGroup`), so the
composed side's shared ``smax`` and int32 sum are the group's.  The scale
is also held against the reference's Pallas quant kernel, run in interpret
mode as tests/test_kernels.py runs it.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.kernels.quant.quant import quantize as jax_quantize
from repro_torch.kernels.quant.quant import (ef_absmax, ef_absmax_plain,
                                             ef_decode, ef_decode_plain,
                                             ef_parts, ef_requant,
                                             ef_requant_plain)
from repro_torch.optim import grad_compress as gc


class ThreadGroup:
    """``torch.distributed``'s ``all_reduce`` (MAX, SUM) and
    ``get_world_size`` for ``world`` threads of one process, each a rank."""

    ReduceOp = dist.ReduceOp

    def __init__(self, world: int):
        self.world = world
        self.barrier = threading.Barrier(world)
        self.slots: dict = {}
        self.calls = threading.local()

    def get_world_size(self, group=None) -> int:
        return self.world

    def all_reduce(self, t: torch.Tensor, op, group=None) -> None:
        call = getattr(self.calls, "n", 0)
        self.calls.n = call + 1
        self.slots[(call, threading.get_ident())] = t.clone()
        self.barrier.wait()
        vals = torch.stack([v for (c, _), v in self.slots.items()
                            if c == call])
        t.copy_(group_reduce(vals, op))
        self.barrier.wait()


def group_reduce(vals: torch.Tensor, op) -> torch.Tensor:
    """The collective's result over the ranks' stacked tensors (a NaN
    anywhere makes a MAX NaN)."""
    if op == dist.ReduceOp.MAX:
        return vals.amax(0)
    return vals.sum(0, dtype=vals.dtype)


def run_ranks(world: int, fn, monkeypatch) -> list:
    """fn(rank) on ``world`` threads with ``grad_compress``'s collectives
    those of a :class:`ThreadGroup`; returns the results by rank."""
    monkeypatch.setattr(gc, "dist", ThreadGroup(world))
    out, errors = [None] * world, []

    def body(r):
        try:
            out[r] = fn(r)
        except Exception as e:      # re-raised below; the others must not
            errors.append(e)        # wait at the barrier for this rank
            gc.dist.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def ef_inputs(n, dtype, with_err, case, world, seed=0):
    """Per-rank gradients (x's dtype) and f32 error carries (or None), of
    different magnitudes on each rank so that the group's scale differs
    from most ranks' own."""
    rng = np.random.default_rng(seed)
    xs, errs = [], []
    for r in range(world):
        x = (rng.standard_normal(n) * 1e-3 * (1 + r)).astype(np.float32)
        e = (rng.standard_normal(n) * 1e-5).astype(np.float32)
        if case == "zero":
            x[:] = 0
            e[:] = 0
        elif case == "nan" and r == world - 1:
            x[n // 3] = np.nan
        xs.append(torch.tensor(x).to(getattr(torch, dtype)))
        errs.append(torch.tensor(e) if with_err else None)
    return xs, errs


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a NaN equal to a NaN of the same bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        width = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return bool(torch.equal(a.view(width), b.view(width)))
    return bool(torch.equal(a, b))


@pytest.mark.parametrize("world", [1, 3, 4])
@pytest.mark.parametrize("n", [2048, 1 << 20])
@pytest.mark.parametrize("case", ["random", "nan", "zero"])
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("with_err", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_split_equals_compressed_psum_plain(dtype, with_err, mean, case,
                                               n, world, monkeypatch):
    xs, errs = ef_inputs(n, dtype, with_err, case, world)
    # the three plain slices, composed around the group's collectives
    s = [ef_absmax_plain(x, e) for x, e in zip(xs, errs)]
    smax = group_reduce(torch.stack(s), dist.ReduceOp.MAX)
    req = [ef_requant_plain(x, e, si, smax) for x, e, si in zip(xs, errs, s)]
    total = group_reduce(torch.stack([q for q, _ in req]), dist.ReduceOp.SUM)
    assert total.dtype == torch.int32
    outs = [ef_decode_plain(total, smax, torch.empty_like(x),
                            world if mean else None) for x in xs]

    def plain(r):
        return gc.compressed_psum_plain(xs[r], None, errs[r], mean=mean)

    def fused(r):
        return gc.compressed_psum(xs[r], None, errs[r], mean=mean)

    for name, fn in (("compressed_psum_plain", plain),
                     ("compressed_psum", fused)):
        got = run_ranks(world, fn, monkeypatch)
        for r in range(world):
            out, new_err = got[r]
            assert same_bits(out, outs[r]), f"{name}: rank {r}'s output"
            assert same_bits(new_err, req[r][1]), f"{name}: rank {r}'s error"
    # each rank's scale is its quantize_int8 scale
    for r in range(world):
        xf = xs[r].float() if errs[r] is None else xs[r].float() + errs[r]
        assert same_bits(s[r].reshape(()), gc.quantize_int8(xf)[1])
    if case == "nan":            # the group's scale is NaN: every q2 0
        assert torch.isnan(smax).all() and not total.any()
    if case == "zero":           # the floor of the scale: all zero
        assert float(smax) == np.float32(1e-30) and not total.any()
        assert not any(o.any() for o in outs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nan", [False, True])
def test_ef_absmax_plain_matches_reference_kernel(dtype, nan):
    xs, errs = ef_inputs(4096, dtype, True, "nan" if nan else "random", 1)
    xf = xs[0].float() + errs[0]
    _, js = jax_quantize(jnp.asarray(xf.numpy()), block=4096, interpret=True)
    s = ef_absmax_plain(xs[0], errs[0])
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_ef_wrappers_run_plain_and_count_nothing_on_cpu():
    xs, errs = ef_inputs(3000, "float32", True, "random", 1, seed=3)
    x, err = xs[0], errs[0].clone()
    n0 = (ef_absmax.launches, ef_requant.launches, ef_decode.launches)
    s = ef_absmax(x, err)
    assert same_bits(s, ef_absmax_plain(x, err))
    smax = s * 2
    want_q, want_e = ef_requant_plain(x, err, s, smax)
    q2, new_err = ef_requant(x, err, s, smax, err)    # in place
    assert new_err is err and same_bits(q2, want_q) and same_bits(err, want_e)
    out = ef_decode(q2, smax, x.clone(), 3)
    assert same_bits(out, ef_decode_plain(q2, smax, torch.empty_like(x), 3))
    assert (ef_absmax.launches, ef_requant.launches,
            ef_decode.launches) == n0
    with pytest.raises(ValueError, match="cpu or cuda"):
        ef_absmax(torch.empty(512, device="meta"))


@pytest.mark.parametrize("n,sms,want", [
    (2048, 132, 1),                    # the norms: one CTA, one launch
    (22 * 2048, 132, 3),
    (22 * 2048 * 5632, 132, 1056),     # tinyllama's wi: 8 CTAs an SM
])
def test_ef_absmax_parts(n, sms, want):
    assert ef_parts(n, sms) == want
