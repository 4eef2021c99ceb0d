"""Plain-PyTorch oracle for per-block int8 quantize/dequantize, under the
names and signatures of ``repro/kernels/quant/ref.py``: the plain versions
of :mod:`.quant`, which hold ``/ 127`` as XLA compiles it and send a NaN's
``q`` to 0."""
from __future__ import annotations

import torch

from repro_torch.kernels.quant.quant import dequantize_plain, quantize_plain


def quant_ref(x: torch.Tensor, block: int = 256):
    """x: (T,) → (q (T,) int8, scales (T/block,) f32)."""
    return quantize_plain(x, block)


def dequant_ref(q: torch.Tensor, s: torch.Tensor, block: int = 256):
    return dequantize_plain(q, s, block)
