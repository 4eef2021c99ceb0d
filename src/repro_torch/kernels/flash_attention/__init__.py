"""Flash attention for prefill and paged flash-decode: CUDA kernels with
their plain PyTorch versions."""
from repro_torch.kernels.flash_attention.flash import (  # noqa: F401
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention.paged import (  # noqa: F401
    paged_decode, paged_decode_plain)
