"""The Mamba2 SSD chunked scan: a CUDA kernel with its plain PyTorch
version."""
from repro_torch.kernels.ssd.ssd import ssd_scan, ssd_scan_plain  # noqa: F401
