"""Per-block symmetric int8 quantize and dequantize.

Replaces ``repro/kernels/quant/quant.py::_quant_kernel`` and
``::_dequant_kernel`` (CUDA: ``csrc/quant.cu``).  For each block of
``block`` elements::

    s = max(max|x| / 127, 1e-30)      q = clip(round(x / s), -127, 127)
    x = q · s                          (the inverse)

The gradient compressor (``optim/grad_compress.py``) runs the same
arithmetic at ``block = numel`` (one scale per tensor) through three fused
kernels of its own, :func:`ef_absmax`, :func:`ef_requant` and
:func:`ef_decode`: its error-feedback encode split around its two
collectives, so that each pass reads a gradient leaf once.
:func:`quantize_plain` and :func:`dequantize_plain` repeat the arithmetic
with PyTorch; the wrappers run them for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernels against them bit for bit.  A NaN in a
block makes its scale NaN and its ``q`` 0, as XLA's float-to-int
conversion does in the reference.

The numbers are the reference kernel's as XLA runs it (interpret mode):
XLA rewrites the kernel's ``max|x| / 127`` into a product with the f32
constant 1/127, which is 1 ulp from the quotient for some maxima, and
:data:`INV127` does the same; ``x / s`` stays an IEEE division.  (JAX run
op by op divides instead, and a compiled program may do either, so the
reference's jnp ``grad_compress`` can differ from its own kernel by 1 ulp
in a scale; the tests account for that.)
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, plain

DTYPES = (torch.float32, torch.bfloat16)
SMALL_BLOCK = 4096          # the kernel's one-warp-per-block limit
CTAS_PER_SM = 8             # large blocks: slices per block fill the card
INV127 = float(np.float32(1) / np.float32(127))    # XLA's `/ 127`


def _blocks(T: int, block: int) -> int:
    if block <= 0 or T % block:
        raise ValueError(f"T={T} must divide block={block}")
    return T // block


def _scales(xb: torch.Tensor) -> torch.Tensor:
    """(nb, block) f32 → the blocks' scales (nb,)."""
    return torch.clamp_min(xb.abs().amax(1) * INV127, 1e-30)


def _quant(xb: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(nb, block) f32 and their scales (nb,) → q (nb, block) int8."""
    r = torch.round(xb / s[:, None]).clamp(-127, 127)
    return torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)


def quantize_plain(x: torch.Tensor, block: int):
    """x (T,) → (q (T,) int8, s (T / block,) f32), in f32."""
    nb = _blocks(x.shape[0], block)
    xb = x.float().reshape(nb, block)
    s = _scales(xb)
    return _quant(xb, s).reshape(-1), s


def dequantize_plain(q: torch.Tensor, s: torch.Tensor, block: int):
    """q (T,) int8, s (T / block,) → x (T,) f32."""
    nb = _blocks(q.shape[0], block)
    return (q.float().reshape(nb, block) * s[:, None]).reshape(-1)


def slices(T: int, block: int, sms: int) -> int:
    """Slices per block in the kernel's two-pass path (block > 4096): about
    ``CTAS_PER_SM`` CTAs per SM over all blocks, each slice at least 4096
    elements."""
    nb = T // block
    if block <= SMALL_BLOCK:
        return 1
    want = -(-CTAS_PER_SM * sms // nb)
    return max(1, min(want, -(-block // SMALL_BLOCK)))


_QUANT_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_DEQUANT_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                 + [ctypes.c_int, ctypes.c_void_p])


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def quantize(x: torch.Tensor, *, block: int = 256):
    """x (T,) f32 or bf16 → (q (T,) int8, s (T / block,) f32); ``T %
    block != 0`` raises ``ValueError``.  CPU tensors take the plain
    version; CUDA tensors the kernel (which raises on a failed launch)."""
    nb = _blocks(x.shape[0], block)
    if plain(x):
        return quantize_plain(x, block)
    _check_device(x)
    if x.dim() != 1 or x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"quantize takes a contiguous (T,) tensor of "
                         f"{DTYPES}; got {x.dtype} {tuple(x.shape)}")
    dev = x.device
    T = x.shape[0]
    sms = _sms(dev)
    parts = slices(T, block, sms)
    q = torch.empty((T,), dtype=torch.int8, device=dev)
    s = torch.empty((nb,), dtype=torch.float32, device=dev)
    partial = torch.empty((nb * parts if block > SMALL_BLOCK else 1,),
                          dtype=torch.float32, device=dev)
    fn = build.function("repro_quant", _QUANT_ARGS)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), partial.data_ptr(),
                 T, block, parts, int(x.dtype == torch.bfloat16), sms,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "quantize")
    quantize.launches += 1
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor, *, block: int = 256):
    """q (T,) int8, s (T / block,) f32 → x (T,) f32.  CPU tensors take the
    plain version; CUDA tensors the kernel."""
    nb = _blocks(q.shape[0], block)
    if plain(q):
        return dequantize_plain(q, s, block)
    _check_device(q)
    if (q.dim() != 1 or q.dtype != torch.int8 or s.dtype != torch.float32
            or tuple(s.shape) != (nb,) or s.device != q.device
            or not (q.is_contiguous() and s.is_contiguous())):
        raise ValueError(f"dequantize takes contiguous q (T,) int8 and s "
                         f"(T / block,) f32 on one device; got q {q.dtype} "
                         f"{tuple(q.shape)}, s {s.dtype} {tuple(s.shape)} on "
                         f"{s.device}")
    dev = q.device
    x = torch.empty((q.shape[0],), dtype=torch.float32, device=dev)
    fn = build.function("repro_dequant", _DEQUANT_ARGS)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), s.data_ptr(), x.data_ptr(), q.shape[0], block,
                 _sms(dev), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "dequantize")
    dequantize.launches += 1
    return x


quantize.launches = 0
dequantize.launches = 0


def _check_device(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"quantize/dequantize run on cpu or cuda, got "
                         f"{t.device}")


# ---------------------------------------------------------------------------
# The gradient compressor's error-feedback encode, one leaf x (any shape, f32
# or bf16) with its f32 error carry err (or None), in three kernels around
# the two collectives of ``optim/grad_compress.py::compressed_psum``:
#
#   s = ef_absmax(x, err)                       the scale of x + err
#   smax = all_reduce(MAX) of s
#   total, err = ef_requant(x, err, s, smax)    int32 wire values, new error
#   all_reduce(SUM) of total
#   ef_decode(total, smax, g, world)            g ← total·smax / world
#
# Each ``*_plain`` is the matching slice of ``compressed_psum_plain``'s op by
# op body, and their composition equals it bit for bit.
# ---------------------------------------------------------------------------

EF_SLICE = 16384            # ef_absmax: at least this many elements a CTA


def _ef_input(x: torch.Tensor, err) -> torch.Tensor:
    """x + err in f32, flat (x alone without a carried error)."""
    xf = x.float().reshape(-1)
    return xf if err is None else xf + err.reshape(-1)


def ef_absmax_plain(x: torch.Tensor, err=None) -> torch.Tensor:
    """x (+ err) → s (1,) f32 = max(max|x + err| / 127, 1e-30)."""
    return _scales(_ef_input(x, err).view(1, -1))


def ef_requant_plain(x: torch.Tensor, err, s: torch.Tensor,
                     smax: torch.Tensor, err_out=None):
    """x (+ err) with its scale s and the group's largest scale smax →
    (q2 int32 shaped like x, the new f32 error): q = x + err quantized by s,
    requantized against smax; the error is ``((x + err − q·s) + q·s) −
    q2·smax``, rounded step by step.  ``err_out`` (f32, like x) receives
    the error if given (it may be ``err``)."""
    xf = _ef_input(x, err)
    n = xf.numel()
    deq = dequantize_plain(_quant(xf.view(1, n), s).view(-1), s, n)
    # a NaN becomes 0, as XLA's float-to-int conversion makes it
    q2 = torch.round(deq / smax).clamp_(-127, 127).nan_to_num_(0.0).to(
        torch.int8)
    new_err = xf - deq
    new_err += deq
    new_err -= dequantize_plain(q2, smax, n)
    new_err = new_err.view(x.shape)
    return (q2.to(torch.int32).view(x.shape),
            new_err if err_out is None else err_out.copy_(new_err))


def ef_decode_plain(total: torch.Tensor, smax: torch.Tensor,
                    out: torch.Tensor, world=None) -> torch.Tensor:
    """out ← total·smax, divided by ``world`` unless it is None, in out's
    dtype; returns out."""
    v = total.float().reshape(-1)
    v *= smax
    if world is not None:       # an IEEE division: a tensor divisor, as
        # PyTorch's CUDA kernels multiply by a Python number's reciprocal
        v.div_(torch.tensor(float(world), device=v.device))
    return out.copy_(v.view(out.shape))


_EF_ABSMAX_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_EF_REQUANT_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_EF_DECODE_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def ef_parts(n: int, sms: int) -> int:
    """CTAs of :func:`ef_absmax` for a leaf of n elements: one per
    ``EF_SLICE`` elements, at most ``CTAS_PER_SM`` per SM."""
    return max(1, min(-(-n // EF_SLICE), CTAS_PER_SM * sms))


def _ef_check(name: str, t: torch.Tensor, dtypes, n: int, dev) -> None:
    if (t.dtype not in dtypes or t.numel() != n or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors of {n} elements "
                         f"of {dtypes} on {dev}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _ef_args(name: str, x: torch.Tensor, err, scales=()) -> None:
    _check_device(x)
    n, dev = x.numel(), x.device
    _ef_check(name, x, DTYPES, n, dev)
    if err is not None:
        _ef_check(name, err, (torch.float32,), n, dev)
    for t in scales:
        _ef_check(name, t, (torch.float32,), 1, dev)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def ef_absmax(x: torch.Tensor, err=None) -> torch.Tensor:
    """x (+ err) → its scale s (1,) f32.  CPU tensors take the plain
    version; CUDA tensors the kernel (contiguous x of f32 or bf16, err f32
    or None; anything else raises)."""
    if plain(x):
        return ef_absmax_plain(x, err)
    _ef_args("ef_absmax", x, err)
    dev, n = x.device, x.numel()
    parts = ef_parts(n, _sms(dev))
    s = torch.empty((1,), dtype=torch.float32, device=dev)
    partial = (torch.empty((parts,), dtype=torch.float32, device=dev)
               if parts > 1 else s)
    fn = build.function("repro_ef_absmax", _EF_ABSMAX_ARGS)
    with torch.cuda.device(dev):
        e = fn(x.data_ptr(), None if err is None else err.data_ptr(),
               partial.data_ptr(), s.data_ptr(), n, parts,
               int(x.dtype == torch.bfloat16), _stream(dev))
    build.check(e, "ef_absmax")
    ef_absmax.launches += 1
    return s


def ef_requant(x: torch.Tensor, err, s: torch.Tensor, smax: torch.Tensor,
               err_out=None):
    """x (+ err), its scale s (1,) and the group's smax (1,) → (q2 int32
    shaped like x, the new f32 error, written into ``err_out`` if given:
    it may be ``err``).  CPU tensors take the plain version; CUDA tensors
    the kernel."""
    if plain(x):
        return ef_requant_plain(x, err, s, smax, err_out)
    _ef_args("ef_requant", x, err, (s, smax))
    dev, n = x.device, x.numel()
    if err_out is None:
        err_out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    _ef_check("ef_requant", err_out, (torch.float32,), n, dev)
    q2 = torch.empty(x.shape, dtype=torch.int32, device=dev)
    fn = build.function("repro_ef_requant", _EF_REQUANT_ARGS)
    with torch.cuda.device(dev):
        e = fn(x.data_ptr(), None if err is None else err.data_ptr(),
               err_out.data_ptr(), q2.data_ptr(), s.data_ptr(),
               smax.data_ptr(), n, int(x.dtype == torch.bfloat16),
               _sms(dev), _stream(dev))
    build.check(e, "ef_requant")
    ef_requant.launches += 1
    return q2, err_out


def ef_decode(total: torch.Tensor, smax: torch.Tensor, out: torch.Tensor,
              world=None) -> torch.Tensor:
    """out ← total·smax (int32 total, smax (1,) f32), divided by ``world``
    unless it is None, in out's dtype (f32 or bf16); returns out.  CPU
    tensors take the plain version; CUDA tensors the kernel."""
    if plain(total):
        return ef_decode_plain(total, smax, out, world)
    _check_device(total)
    dev, n = total.device, total.numel()
    _ef_check("ef_decode", total, (torch.int32,), n, dev)
    _ef_check("ef_decode", smax, (torch.float32,), 1, dev)
    _ef_check("ef_decode", out, DTYPES, n, dev)
    if world is not None and world < 1:
        raise ValueError(f"ef_decode: world {world} must be at least 1")
    fn = build.function("repro_ef_decode", _EF_DECODE_ARGS)
    with torch.cuda.device(dev):
        e = fn(total.data_ptr(), smax.data_ptr(), out.data_ptr(), n,
               world or 0, int(out.dtype == torch.bfloat16), _sms(dev),
               _stream(dev))
    build.check(e, "ef_decode")
    ef_decode.launches += 1
    return out


ef_absmax.launches = 0
ef_requant.launches = 0
ef_decode.launches = 0
