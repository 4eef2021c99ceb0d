"""Kernel tile geometry.  Only the serving slice's tile is ported; the
other kernel families' tiles, and the per-hardware autotuner of
``repro.kernels.autotune`` (retargeted from TPU VMEM to Hopper shared
memory), come with their slices."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelTiles:
    """One device group's tile geometry."""
    page_size: int = 64         # paged-KV decode page rows (serving)


DEFAULT_TILES = KernelTiles()
