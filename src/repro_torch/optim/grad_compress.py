"""Int8 error-feedback gradient compression for the cross-pod all-reduce.

The port of ``repro/optim/grad_compress.py``.  Only gradients cross the
slow pod axis; quantising them to int8 with one scale per tensor cuts
those bytes 4×, and the residual of the quantisation is carried to the
next step and added back (error feedback; Seide et al., 2014; Karimireddy
et al., 2019).

The reference's encode and decode are jnp with the semantics of its Pallas
``quant`` kernel; here they *are* that kernel's port:
``quantize_int8(x)`` is ``quantize(x.reshape(-1), block=x.numel())`` and
``dequantize_int8(q, s)`` is ``dequantize(q, s, block=q.numel())``, which
compute exactly the reference's numbers (one block = one per-tensor
scale) — the kernel's numbers, which XLA gives the reference's jnp too
when it compiles ``/ 127`` into a product with 1/127.  Every other
operation rounds as the jnp reads op by op: IEEE divisions, and no fused
multiply-add in the residual (XLA on the CPU fuses ``x − q·s`` into one,
so a compiled reference differs there in the last bit).  On a CUDA tensor they launch ``csrc/quant.cu``; on a CPU tensor
they run the plain versions.

:func:`compressed_psum` runs inside every rank of a ``torch.distributed``
group (the ``pod`` group of the mesh): ``jax.lax.pmax`` becomes an
``all_reduce(MAX)`` of the scale, ``psum`` of the int8 values an
``all_reduce(SUM)`` of int32, ``axis_size`` the group's size.  A group of
one still runs both collectives, as a ``psum`` over a size-1 axis does.
Around the collectives it runs three fused kernels of ``csrc/quant.cu``
(``kernels/quant/quant.py::ef_absmax``, ``ef_requant``, ``ef_decode``),
32 bytes per gradient element in all, where XLA fuses the reference's jnp;
on CPU tensors their plain versions.  :func:`compressed_psum_plain` is the
same function op by op through ``quantize`` and ``dequantize`` (the tests'
and ``chip_smoke.py``'s yardstick, equal bit for bit).

A rank may hold only a block of a leaf: a shard over ``model`` or a ZeRO
slice or shard over ``data``.  The reference compresses in a ``shard_map``
manual over ``pod`` alone, with GSPMD splitting the other axes inside, so
its scale is ``max|x|`` over the pod's whole leaf.  ``split_groups``
names the groups a block is cut over: the block's abs-max is all-reduced
(MAX) over them before the pod's, so every block quantizes against its
whole leaf's scale.  A maximum is exact, so the result does not depend on
how the leaf is cut.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.quant.quant import (dequantize, ef_absmax,
                                             ef_decode, ef_requant,
                                             quantize)
from repro_torch.tree import flatten, tree_map


def _encode(xf: torch.Tensor):
    """f32 x → (q int8 shaped like x, 0-d f32 scale, q·scale f32)."""
    n = xf.numel()
    q, s = quantize(xf.reshape(-1), block=n)
    deq = dequantize(q, s, block=n).view(xf.shape)
    return q.view(xf.shape), s[0], deq


def quantize_int8(x: torch.Tensor, err: torch.Tensor | None = None):
    """x (+ carried error) → (int8 q, f32 scale, new error).

    Symmetric per-tensor scaling: q = round(x / s), s = max|x| / 127.
    """
    xf = x.float()
    if err is not None:
        xf = xf + err
    q, scale, deq = _encode(xf)
    return q, scale, xf - deq


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    n = q.numel()
    return dequantize(q.reshape(-1), scale.reshape(1), block=n).view(q.shape)


def compressed_psum(x: torch.Tensor, group=None,
                    err: torch.Tensor | None = None, *, mean: bool = True,
                    split_groups: tuple = ()):
    """Error-feedback int8 all-reduce of ``x`` over ``group`` (``None``:
    the default group).  Returns (reduced tensor in x's dtype, new f32
    error).

    Every rank quantises with its own scale; the int8 values are
    requantised against the largest scale in the group, so their int32 sum
    times that scale is the sum up to int8 resolution, and the residual of
    both quantisations goes to the error carry.  Where ``x`` is a block of
    a leaf cut over ``split_groups``, its scale is the whole leaf's (their
    MAX).  On the card x and err must be contiguous.
    """
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    new_err = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _psum_into(x, group, err, out, new_err, mean, split_groups)
    return out, new_err


def _leaf_max(s: torch.Tensor, split_groups) -> torch.Tensor:
    """A block's scale ``s`` made its whole leaf's, in place: the MAX over
    the groups the leaf is cut over."""
    for g in split_groups:
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=g)
    return s


def _psum_into(x, group, err, out, err_out, mean: bool,
               split_groups=()) -> None:
    """:func:`compressed_psum` of x, written into out and err_out (which
    may be x and err)."""
    s = _leaf_max(ef_absmax(x, err), split_groups)
    smax = s.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    total, _ = ef_requant(x, err, s, smax, err_out)
    del s
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    ef_decode(total, smax, out,
              dist.get_world_size(group) if mean else None)


def compressed_psum_plain(x: torch.Tensor, group=None,
                          err: torch.Tensor | None = None, *,
                          mean: bool = True, split_groups: tuple = ()):
    """:func:`compressed_psum` op by op, through ``quantize`` and
    ``dequantize`` (their kernels on the card).  The order of operations
    is the reference's; ``q·scale`` is computed once and used where the
    reference computes it three times (the same values).  A block cut over
    ``split_groups`` is quantized again, op by op, against its leaf's
    scale where that is larger than its own."""
    xf = x.float()
    if err is not None:
        xf = xf + err
    q, scale, deq = _encode(xf)
    if split_groups:
        scale = _leaf_max(scale.reshape(1).clone(), split_groups)[0]
        r = torch.round(xf / scale).clamp_(-127, 127).nan_to_num_(0.0)
        q = r.to(torch.int8)
        deq = dequantize_int8(q, scale)
    smax = scale.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    # a NaN becomes 0, as XLA's float-to-int conversion makes it
    r = torch.round(deq / smax).clamp_(-127, 127).nan_to_num_(0.0)
    q2 = r.to(torch.int8)
    del r
    new_err = xf - deq                 # quantize_int8's residual ...
    del xf
    new_err += deq                     # ... + q·scale − q2·smax, in order
    del deq
    new_err -= dequantize_int8(q2, smax)
    total = q2.to(torch.int32)
    del q, q2
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    out = total.float()
    del total
    out *= smax
    if mean:                # an IEEE division: a 0-d tensor divisor, as
        # PyTorch's CUDA kernels multiply by a Python number's reciprocal
        out.div_(torch.tensor(float(dist.get_world_size(group)),
                              device=out.device))
    return out.to(x.dtype), new_err


def init_error_tree(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum_tree(grads: dict, group, err_tree: dict, *,
                         mean: bool = True, split_groups: dict | None = None):
    """:func:`compressed_psum` over every leaf, in the reference's leaf
    order (sorted key paths); returns (reduced grads, new error tree).
    ``split_groups``: a tree like ``grads`` holding, per leaf, the tuple
    of groups its block is cut over (``None``: every leaf whole).

    Unlike the reference, which returns new trees, the results are written
    into ``grads`` and ``err_tree`` in place (the trees returned are those
    two): at tinyllama-1.1b's size that saves two 4.4 GB f32 trees, and
    each leaf's temporaries are freed before the next leaf starts."""
    leaves = flatten(grads)[1]
    over = (flatten(split_groups)[1] if split_groups is not None
            else [()] * len(leaves))
    for g, e, sg in zip(leaves, flatten(err_tree)[1], over):
        _psum_into(g, group, e, g, e, mean, sg)
    return grads, err_tree
