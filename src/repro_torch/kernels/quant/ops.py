"""The quant kernels' entry points under the reference's names
(``repro/kernels/quant/ops.py``).  PyTorch runs eagerly, so there is no
``jit`` to wrap and the wrappers are the entry points themselves;
``interpret`` has no counterpart: a CPU tensor runs the plain version."""
from __future__ import annotations

from repro_torch.kernels.quant.quant import dequantize as dequant  # noqa: F401
from repro_torch.kernels.quant.quant import quantize as quant  # noqa: F401
