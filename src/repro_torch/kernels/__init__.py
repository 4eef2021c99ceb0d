"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

Every kernel sits beside its plain PyTorch version in the same module.  A
wrapper runs the plain version for CPU tensors and launches the kernel for
CUDA tensors, counting each launch on the wrapper (``fn.launches``); any
other device raises — but for ``meta`` tensors (shapes only) inside
:func:`abstract`, the annotation API's capture
(``repro_torch.core.ir.capture_meta``), which run the plain version and
so allocate and launch nothing.  The CUDA sources in ``csrc/`` are
compiled at first use by :mod:`.build`.
"""
import contextlib
import threading

import torch

_capture = threading.local()


@contextlib.contextmanager
def abstract():
    """Within it, on this thread, wrappers given ``meta`` tensors run
    their plain versions (outside it they raise, as on any device that is
    neither the CPU nor a card)."""
    was = getattr(_capture, "on", False)
    _capture.on = True
    try:
        yield
    finally:
        _capture.on = was


def plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs the plain version: ``t`` lies on
    the CPU, or on the ``meta`` device inside :func:`abstract`."""
    return t.device.type == "cpu" or (t.device.type == "meta"
                                      and getattr(_capture, "on", False))
