"""Profiling mode: timing observations → calibrated ``Hardware`` tables;
the port of ``repro/runtime/profiler.py``.

The recording half of the sim-to-measured loop (DESIGN.md §10;
:mod:`repro_torch.core.calibrate` is the fitting half).  A :class:`Profiler`
accumulates per-device-group :class:`~repro_torch.core.calibrate.Observation`\\ s
from whatever timing source is available:

- whole training steps (``record_step``) with the feature vector from
  ``cost_model.step_cost_features`` — what ``launch/train.py --profile``
  feeds it each step, timed on the card (a simulated clock in tests);
- individual collectives (``record_collective``), converted to
  ring-*effective* byte volumes with the same formulas the cost model
  prices, so the fitted bandwidth is directly the table entry;
- HBM-bound kernels (``record_kernel``) by traffic bytes.

(The reference also records whole compiled modules, ``record_hlo``, with
byte volumes read from their HLO; that comes with the port of
``launch/hlo_analysis.py``.)

Observations are windowed per group (``max_per_group`` keeps memory bounded
and lets drifting hardware age out of the fit) and turned into
:class:`~repro_torch.core.calibrate.CalibratedHardware` via ``fit_group`` /
``fit_spec``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.calibrate import (CalibratedHardware, Observation,
                                        fit, prediction_error, refit_spec)
from repro_torch.core.cost_model import (ClusterSpec, Hardware,
                                         all_gather_time, all_reduce_time,
                                         all_to_all_time,
                                         hardware_reciprocals, p2p_time)

__all__ = ["Profiler", "ring_effective_bytes"]


# Ring-effective byte volume per collective kind at unit bandwidth — the
# same formulas step_cost prices with, so fitted bandwidth == table entry.
_RING = {
    "all-reduce": lambda b, n: all_reduce_time(b, n, 1.0),
    "all-gather": lambda b, n: all_gather_time(b, n, 1.0),
    "reduce-scatter": lambda b, n: all_gather_time(b, n, 1.0),
    "all-to-all": lambda b, n: all_to_all_time(b, n, 1.0),
    "collective-permute": lambda b, n: p2p_time(b, 1.0),
    "p2p": lambda b, n: p2p_time(b, 1.0),
}


def ring_effective_bytes(kind: str, payload_bytes: float, n: int) -> float:
    """Bytes actually moved per link by one ``kind`` over ``n`` ranks."""
    try:
        return _RING[kind](float(payload_bytes), int(n))
    except KeyError:
        raise ValueError(
            f"unknown collective kind {kind!r}; expected one of "
            f"{sorted(_RING)}") from None


@dataclasses.dataclass
class Profiler:
    """Accumulates timing observations per device group and fits tables.

    ``max_per_group`` bounds each group's buffer; recording past it drops
    the oldest observations, so long-running jobs fit over a sliding
    window and hardware drift ages out instead of being averaged away.
    """
    max_per_group: int = 4096

    def __post_init__(self) -> None:
        self._obs: dict[str, list[Observation]] = {}

    # -- recording ----------------------------------------------------------

    def record(self, obs: Observation) -> None:
        buf = self._obs.setdefault(obs.group, [])
        buf.append(obs)
        if len(buf) > self.max_per_group:
            del buf[: len(buf) - self.max_per_group]

    def record_step(self, group: str, wall_s: float,
                    features: Mapping[str, float], *, step: int = -1) -> None:
        """One whole training step: ``features`` from step_cost_features."""
        if wall_s > 0.0:
            self.record(Observation("step", group, float(wall_s),
                                    dict(features), step))

    def record_compute(self, group: str, wall_s: float, flops: float, *,
                       step: int = -1) -> None:
        """A pure-compute interval (matmul-dominated, no collectives)."""
        if wall_s > 0.0 and flops > 0.0:
            self.record(Observation("compute", group, float(wall_s),
                                    {"eff_flops": float(flops)}, step))

    def record_collective(self, group: str, kind: str, payload_bytes: float,
                          n: int, wall_s: float, *, link: str = "fast",
                          step: int = -1) -> None:
        """One timed collective over ``n`` ranks on the given link kind."""
        eff = ring_effective_bytes(kind, payload_bytes, n)
        if wall_s > 0.0 and eff > 0.0:
            self.record(Observation("collective", group, float(wall_s),
                                    {"link_" + link: eff}, step))

    def record_kernel(self, group: str, hbm_bytes: float, wall_s: float, *,
                      step: int = -1) -> None:
        """An HBM-bound kernel by its traffic bytes."""
        if wall_s > 0.0 and hbm_bytes > 0.0:
            self.record(Observation("kernel", group, float(wall_s),
                                    {"hbm_bw": float(hbm_bytes)}, step))

    # -- inspection ---------------------------------------------------------

    @property
    def groups(self) -> tuple[str, ...]:
        return tuple(self._obs)

    def n_obs(self, group: str | None = None) -> int:
        if group is not None:
            return len(self._obs.get(group, ()))
        return sum(len(v) for v in self._obs.values())

    def window(self, group: str,
               last_n: int | None = None) -> list[Observation]:
        buf = self._obs.get(group, [])
        return list(buf if last_n is None else buf[-last_n:])

    def clear(self, group: str | None = None) -> None:
        if group is None:
            self._obs.clear()
        else:
            self._obs.pop(group, None)

    # -- fitting ------------------------------------------------------------

    def fit_group(self, group: str, base: Hardware, *,
                  last_n: int | None = None, **kw) -> CalibratedHardware:
        """Fit ``base`` from this group's (windowed) observations."""
        return fit(self.window(group, last_n), base, **kw)

    def fit_spec(self, spec: ClusterSpec, *, last_n: int | None = None,
                 **kw) -> tuple[ClusterSpec, dict[str, CalibratedHardware]]:
        """Re-fit every group of ``spec`` that has observations.

        Returns the calibrated spec plus the per-group fits (for event
        logs / ``rebalance(hardware=...)``).  Groups without observations
        keep their prior table.
        """
        fits = {g.name: self.fit_group(g.name, g.hw, last_n=last_n, **kw)
                for g in spec.groups if self.n_obs(g.name)}
        return refit_spec(spec, fits), fits

    def error(self, group: str, hw: Hardware, *,
              last_n: int | None = None) -> float:
        """Mean relative predicted-vs-measured error on the window."""
        return prediction_error(self.window(group, last_n), hw)

    def report(self, spec: ClusterSpec, *,
               last_n: int | None = None) -> str:
        """Human-readable calibration table (``launch/train.py --profile``)."""
        lines = ["calibration report (fitted vs prior; confidence in [0,1])"]
        for g in spec.groups:
            n = self.n_obs(g.name)
            if not n:
                lines.append(f"  {g.name}: no observations")
                continue
            fitted = self.fit_group(g.name, g.hw, last_n=last_n)
            prior_r = hardware_reciprocals(g.hw)
            fit_r = hardware_reciprocals(fitted)
            err = self.error(g.name, fitted, last_n=last_n)
            lines.append(f"  {g.name}: n={n} pred_err={err:.3f}")
            for p in sorted(fit_r):
                rate_f, rate_p = 1.0 / fit_r[p], 1.0 / prior_r[p]
                conf = fitted.confidence.get(p, 0.0)
                lines.append(
                    f"    {p:<10} {rate_f:>12.4g}  (prior {rate_p:>12.4g}, "
                    f"x{rate_f / rate_p:5.2f}, conf {conf:.2f})")
        return "\n".join(lines)
