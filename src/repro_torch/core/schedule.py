"""Pipeline schedules as explicit per-tick tables (paper §3.1, Cases 3–4):
the port of ``repro/core/schedule.py``.

Whale's pipeline primitive fixes *what* runs on each stage; this module
fixes *when*.  A :class:`Schedule` is a table of ticks — one row per unit
of pipeline time, one column per stage, each cell either idle or a
``(micro_batch, phase)`` work item with ``phase ∈ {fwd, bwd}`` — plus the
derived quantities the rest of the system consumes:

- the **executor** (the reference's ``core/pipeline.py``; the port's
  pipeline engine is a later slice) walks the table to run
  forward/backward work in exactly the scheduled order, sizing its
  activation buffers to :meth:`Schedule.peak_in_flight`;
- the **cost model** (:mod:`repro_torch.core.cost_model`) prices the bubble via
  :func:`bubble_fraction` and peak activation memory via
  :func:`in_flight_micro_batches`.

Two schedules ship:

``gpipe``
    All forwards, then all backwards (the mirror image).  With S stages
    and M micro-batches the forward wave takes M + S − 1 ticks and the
    backward wave the same, so the span is 2·(M + S − 1) ticks and each
    stage idles (S − 1)/(M + S − 1) of them — the classic bubble.  Every
    stage must hold activations for all M micro-batches at its peak.

``1f1b``
    PipeDream-flush / memory-frugal one-forward-one-backward: each stage
    warms up with at most S − s − 1 forwards, then strictly alternates
    forward and backward, then drains.  Same span and same bubble
    fraction as GPipe (order changes, work does not) but a stage never
    holds more than min(S − s, M) ≤ S in-flight micro-batches — the
    property that lets uneven heterogeneous pipelines fit HBM (HetPipe,
    arXiv:2005.14038).

The module is pure Python (no torch) so schedule properties are testable
anywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FWD = "fwd"
BWD = "bwd"

#: tick-table cell: (micro_batch, phase) or None for an idle slot
Slot = Optional[Tuple[int, str]]

SCHEDULE_NAMES = ("gpipe", "1f1b")


def bubble_fraction_closed_form(n_stages: int, n_micro: int) -> float:
    """(S − 1)/(M + S − 1) — the fraction of a stage's span spent idle.

    Both shipped schedules realize exactly this (1F1B reorders work, it
    does not remove the ramp); schedules are validated against it.
    """
    if n_stages <= 1:
        return 0.0
    return (n_stages - 1) / (n_micro + n_stages - 1)


def in_flight_micro_batches(n_stages: int, n_micro: int,
                            schedule: str = "gpipe") -> int:
    """Peak number of micro-batches whose activations a stage must hold.

    The closed forms the cost model prices activation memory with; the
    tick tables are validated to match (`Schedule.peak_in_flight`).
    """
    if schedule == "1f1b":
        return min(n_stages, n_micro)
    if schedule == "gpipe":
        return n_micro
    raise ValueError(f"unknown schedule {schedule!r}; "
                     f"expected one of {SCHEDULE_NAMES}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A complete pipeline schedule: ``ticks[t][s]`` is stage ``s``'s work
    item at tick ``t`` (or None).  Built by :func:`make_schedule`."""
    name: str
    n_stages: int
    n_micro: int
    ticks: tuple                 # tuple[tuple[Slot, ...], ...]

    @property
    def n_ticks(self) -> int:
        return len(self.ticks)

    def slots(self):
        """Iterate (tick, stage, micro_batch, phase) over busy cells."""
        for t, row in enumerate(self.ticks):
            for s, cell in enumerate(row):
                if cell is not None:
                    yield t, s, cell[0], cell[1]

    # ---- derived properties --------------------------------------------

    def bubble_fraction(self) -> float:
        """Idle fraction of the busiest-possible span, from the table
        itself: each stage owes 2·M work units over ``n_ticks`` ticks."""
        busy_per_stage = 2 * self.n_micro
        return 1.0 - busy_per_stage / self.n_ticks

    def peak_in_flight(self) -> int:
        """max over stages of :meth:`per_stage_in_flight` — the activation
        buffer depth the executor must provision."""
        return max(self.per_stage_in_flight())

    def per_stage_in_flight(self) -> list:
        """Per stage: peak #{micro-batches forwarded but not yet
        backwarded} over the span."""
        peaks = [0] * self.n_stages
        live = [0] * self.n_stages
        for _, s, _, phase in self.slots():
            if phase == FWD:
                live[s] += 1
                peaks[s] = max(peaks[s], live[s])
            else:
                live[s] -= 1
        return peaks

    # ---- validation -----------------------------------------------------

    def validate(self) -> "Schedule":
        """Raise ValueError unless the table is a legal pipeline schedule:

        - every (stage, micro-batch) runs fwd exactly once and bwd exactly
          once;
        - fwd of stage s waits for fwd of stage s−1 on the same micro-batch
          (activations flow down), and bwd of stage s waits for bwd of
          stage s+1 (cotangents flow up) and for its own fwd.
        """
        S, M = self.n_stages, self.n_micro
        done = {}                       # (s, mb, phase) -> tick
        for t, s, mb, phase in self.slots():
            if not (0 <= s < S and 0 <= mb < M):
                raise ValueError(f"tick {t}: slot ({s}, {mb}) out of range")
            if phase not in (FWD, BWD):
                raise ValueError(f"tick {t}: bad phase {phase!r}")
            key = (s, mb, phase)
            if key in done:
                raise ValueError(f"{phase} of stage {s} mb {mb} scheduled "
                                 f"twice (ticks {done[key]} and {t})")
            if phase == FWD and s > 0:
                dep = (s - 1, mb, FWD)
                if done.get(dep, t) >= t:
                    raise ValueError(
                        f"tick {t}: fwd({s},{mb}) before fwd({s - 1},{mb})")
            if phase == BWD:
                if done.get((s, mb, FWD), t) >= t:
                    raise ValueError(
                        f"tick {t}: bwd({s},{mb}) before its own fwd")
                if s < S - 1:
                    dep = (s + 1, mb, BWD)
                    if done.get(dep, t) >= t:
                        raise ValueError(
                            f"tick {t}: bwd({s},{mb}) before "
                            f"bwd({s + 1},{mb})")
            done[(s, mb, phase)] = t
        missing = [(s, mb, ph) for s in range(S) for mb in range(M)
                   for ph in (FWD, BWD) if (s, mb, ph) not in done]
        if missing:
            raise ValueError(f"schedule never runs {missing[:4]}"
                             f"{'…' if len(missing) > 4 else ''}")
        return self

    # ---- executor view --------------------------------------------------

    def as_arrays(self):
        """→ (kind, mb): two (n_ticks, n_stages) int lists for the
        executor's scan — kind 0 = idle, 1 = fwd, 2 = bwd; mb the
        micro-batch index (0 where idle)."""
        kind = [[0] * self.n_stages for _ in range(self.n_ticks)]
        mb = [[0] * self.n_stages for _ in range(self.n_ticks)]
        for t, s, m, phase in self.slots():
            kind[t][s] = 1 if phase == FWD else 2
            mb[t][s] = m
        return kind, mb


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


def gpipe_schedule(n_stages: int, n_micro: int) -> Schedule:
    """All forwards (M + S − 1 tick wave), then the mirrored backwards —
    exactly the order the gradient of a fused forward scan induces."""
    S, M = n_stages, n_micro
    _check(S, M)
    span = M + S - 1
    ticks = []
    for t in range(span):                       # forward wave
        ticks.append(tuple(
            (t - s, FWD) if 0 <= t - s < M else None for s in range(S)))
    for t in range(span):                       # mirrored backward wave
        ticks.append(tuple(
            (t - (S - 1 - s), BWD) if 0 <= t - (S - 1 - s) < M else None
            for s in range(S)))
    return Schedule("gpipe", S, M, tuple(ticks)).validate()


def one_f_one_b_schedule(n_stages: int, n_micro: int) -> Schedule:
    """PipeDream-flush 1F1B via greedy simulation under the in-flight cap.

    Per stage: the in-flight window is capped at min(S − s, M); whenever a
    backward is ready it runs (that *is* the 1F1B policy — the cap forces
    the warmup, readiness forces the alternation), otherwise the next
    forward runs if the cap allows, otherwise the stage idles.
    """
    S, M = n_stages, n_micro
    _check(S, M)
    n_fwd = [0] * S
    n_bwd = [0] * S
    fwd_tick = {}                  # (s, mb) -> completion tick
    bwd_tick = {}
    ticks = []
    limit = [min(S - s, M) for s in range(S)]
    while min(n_bwd) < M:
        t = len(ticks)
        if t > 4 * (M + S):        # safety: a legal schedule is far shorter
            raise RuntimeError(f"1f1b simulation diverged (S={S}, M={M})")
        row = []
        for s in range(S):
            b, f = n_bwd[s], n_fwd[s]
            can_bwd = b < f and (
                bwd_tick.get((s + 1, b), t) < t if s < S - 1
                else fwd_tick.get((s, b), t) < t)
            can_fwd = f < M and (f - b) < limit[s] and (
                s == 0 or fwd_tick.get((s - 1, f), t) < t)
            if can_bwd:
                row.append((b, BWD))
                bwd_tick[(s, b)] = t
                n_bwd[s] += 1
            elif can_fwd:
                row.append((f, FWD))
                fwd_tick[(s, f)] = t
                n_fwd[s] += 1
            else:
                row.append(None)
        ticks.append(tuple(row))
    return Schedule("1f1b", S, M, tuple(ticks)).validate()


_GENERATORS = {"gpipe": gpipe_schedule, "1f1b": one_f_one_b_schedule}


def make_schedule(name, n_stages: int, n_micro: int) -> Schedule:
    """Name (or an already-built Schedule, passed through) → Schedule."""
    if isinstance(name, Schedule):
        return name
    try:
        gen = _GENERATORS[name]
    except KeyError:
        raise ValueError(f"unknown schedule {name!r}; "
                         f"expected one of {SCHEDULE_NAMES}") from None
    return gen(n_stages, n_micro)


def _check(S: int, M: int) -> None:
    if S < 1 or M < 1:
        raise ValueError(f"need n_stages >= 1 and n_micro >= 1, "
                         f"got S={S}, M={M}")
