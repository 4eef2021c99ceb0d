"""Where the port runs: the card unless the caller asks otherwise."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``.  Asking for CUDA on a host without a card
    raises: the port never carries on on the CPU unless told to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch path on the CPU")
    return dev
