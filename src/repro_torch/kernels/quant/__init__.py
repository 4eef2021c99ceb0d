"""Per-block int8 quantize/dequantize: CUDA kernels with their plain
PyTorch versions, and the reference oracle."""
from repro_torch.kernels.quant.ops import dequant, quant  # noqa: F401
from repro_torch.kernels.quant.quant import dequantize, quantize  # noqa: F401
from repro_torch.kernels.quant.ref import dequant_ref, quant_ref  # noqa: F401
