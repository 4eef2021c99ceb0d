"""Kernel tile geometry.  Only the serving slice's page size is ported:
the flash and cross-entropy kernels fix their tiles at compile time
(``csrc/``), and the per-hardware autotuner of ``repro.kernels.autotune``
(retargeted from TPU VMEM to Hopper shared memory) comes with the engine
slice."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelTiles:
    """One device group's tile geometry."""
    page_size: int = 64         # paged-KV decode page rows (serving)


DEFAULT_TILES = KernelTiles()
