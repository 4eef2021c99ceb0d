"""Flash attention (forward and backward; the differentiable op is
``ops.flash``) and paged flash-decode: CUDA kernels with their plain
PyTorch versions."""
from repro_torch.kernels.flash_attention.flash import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_plain, flash_bwd_dkv, flash_bwd_dq)
from repro_torch.kernels.flash_attention.paged import (  # noqa: F401
    paged_decode, paged_decode_plain)
