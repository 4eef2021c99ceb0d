"""Per-block symmetric int8 quantize and dequantize.

Replaces ``repro/kernels/quant/quant.py::_quant_kernel`` and
``::_dequant_kernel`` (CUDA: ``csrc/quant.cu``).  For each block of
``block`` elements::

    s = max(max|x| / 127, 1e-30)      q = clip(round(x / s), -127, 127)
    x = q · s                          (the inverse)

The gradient compressor (``optim/grad_compress.py``) calls them once per
gradient leaf and step with ``block = numel``: one scale per tensor.
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

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
SMALL_BLOCK = 4096          # the kernel's one-warp-per-block limit
CTAS_PER_SM = 8             # large blocks: slices per block fill the card
INV127 = float(np.float32(1) / np.float32(127))    # XLA's `/ 127`


def _blocks(T: int, block: int) -> int:
    if block <= 0 or T % block:
        raise ValueError(f"T={T} must divide block={block}")
    return T // block


def quantize_plain(x: torch.Tensor, block: int):
    """x (T,) → (q (T,) int8, s (T / block,) f32), in f32."""
    nb = _blocks(x.shape[0], block)
    xb = x.float().reshape(nb, block)
    s = torch.clamp_min(xb.abs().amax(1) * INV127, 1e-30)
    r = torch.round(xb / s[:, None]).clamp(-127, 127)
    q = torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)
    return q.reshape(-1), s


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
    if x.device.type == "cpu":
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
    if q.device.type == "cpu":
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
