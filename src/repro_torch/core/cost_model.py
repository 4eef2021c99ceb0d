"""Whale's strategy description: the port of ``StrategySpec`` from
``repro/core/cost_model.py``.

Only :class:`StrategySpec` is ported so far, because the planner's
data-parallel path needs it.  The rest of the reference module (the
``Hardware`` tables, ``ClusterSpec``, ``ModelGraph``, ``step_cost`` and the
calibration features) comes with the slice that ports the cost model and
the auto-search.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """A point in Whale's strategy space for one TaskGraph.

    dp × max(tp, ep) × pp must equal the device count.  ``zero`` ∈
    {0, 1, 2, 3} (stage-3 = FSDP: params sharded over dp).  ``vocab_split``
    shards the classifier head over tp (the paper's Fig-4 technique).
    ``micro_batches`` only matters when pp > 1 (GPipe) or when used for
    grad accumulation.

    ``ep`` is the *nested* expert-parallel degree — the paper's
    ``replicate{split}`` hybrid (§4, the M6 recipe): DP outer, the MoE
    layers' ``experts`` dimension split over the model axis inner.
    ``ep`` rides the same mesh axis as ``tp`` — when both exceed 1 they
    must be equal.
    """
    dp: int = 1
    tp: int = 1
    pp: int = 1
    micro_batches: int = 1
    zero: int = 0
    remat: bool = True
    vocab_split: bool = True
    opt_factored: bool = False     # adafactor-style O(N/d) second moments
    # pipeline schedule: "gpipe" holds all M micro-batches of activations
    # in flight; "1f1b" caps at min(M, pp)
    schedule: str = "gpipe"
    # nested expert parallelism: experts split over the model axis inside
    # each data-parallel replica (replica{split} — Whale §4 nesting)
    ep: int = 1

    def __post_init__(self):
        if self.ep < 1:
            raise ValueError(f"ep must be >= 1, got {self.ep}")
        if self.ep > 1 and self.tp > 1 and self.ep != self.tp:
            raise ValueError(
                f"nested ep={self.ep} and tp={self.tp} ride the same model "
                f"axis and must be equal when both exceed 1")

    @property
    def model_parallel(self) -> int:
        """Size of the model mesh axis: operator split and expert split
        share it (ep == tp when both are active)."""
        return max(self.tp, self.ep)

    @property
    def devices(self) -> int:
        return self.dp * self.model_parallel * self.pp

    def describe(self) -> str:
        bits = []
        inner = []
        if self.tp > 1:
            inner.append(f"split×{self.tp}")
        if self.ep > 1:
            inner.append(f"split[experts]×{self.ep}")
        if self.dp > 1:
            nest = "{" + " ".join(inner) + "}" if inner else ""
            bits.append(f"replica×{self.dp}"
                        + (f"+zero{self.zero}" if self.zero else "") + nest)
        else:
            bits.extend(inner)
        if self.pp > 1:
            sched = "" if self.schedule == "gpipe" else f",{self.schedule}"
            bits.append(f"pipeline×{self.pp}(µb={self.micro_batches}{sched})")
        if self.opt_factored:
            bits.append("adafactor")
        if not bits:
            bits.append("single-device")
        return " ".join(bits)
