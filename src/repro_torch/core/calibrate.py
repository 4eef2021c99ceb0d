"""Profile-guided calibration of ``Hardware`` tables (DESIGN.md §10): the
port of ``repro/core/calibrate.py``.

The cost model prices every plan — batch splits, layer allocations, serving
partitions, kernel tiles — from a hand-written ``Hardware`` table.  A mis-set
entry silently mis-routes all of them at once.  This module closes the
sim-to-measured loop: given timing *observations* recorded by
:mod:`repro_torch.runtime.profiler` (wall-clock on real devices, a
simulated clock in tests), it re-fits the table entries so the
analytic formulas price with measured numbers.

The key structural fact (see ``cost_model.step_cost_features``) is that every
analytic time is **linear in the reciprocals** of the hardware parameters:

    t  =  F·x_flops + H·x_hbm + B_f·x_fast + B_s·x_slow,
    x_p = 1/rate_p,

where the coefficients ``(F, H, B_f, B_s)`` depend only on the workload
(FLOP volume with the pipeline-bubble factor folded in; HBM traffic; ring-
effective bytes per link kind with overlap discounts folded in).  Fitting is
therefore ordinary least squares over the observation design matrix — no
iterative optimiser, no scipy.

Ridge-to-prior regularisation keeps the solve well-posed when observations
are collinear (whole-step times alone cannot separate FLOPs from bandwidth):
unidentifiable directions stay at the prior table's values and report zero
confidence, while decomposed observations (per-collective, per-kernel,
compute-only) make every parameter separately identifiable.

Units: observations timed on a *simulated* clock fit parameters in "FLOPs
(or bytes) per simulated second".  That is internally consistent — every
consumer of the fitted table compares times against other times from the
same table — so relative planning decisions (batch shares, strategy ranking)
are exactly as correct as with real seconds.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.cost_model import (CALIBRATION_PARAMS, ClusterSpec,
                                         Hardware, hardware_reciprocals,
                                         predict_step_time,
                                         step_cost_features)

__all__ = [
    "Observation", "CalibratedHardware", "fit", "prediction_error",
    "refit_spec", "synthesize_observations", "parameter_error",
]


# ---------------------------------------------------------------------------
# observation schema (DESIGN.md §10)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Observation:
    """One timed event attributed to one device group.

    ``features`` maps calibration parameters to their linear coefficients
    (``cost_model.CALIBRATION_PARAMS``): per-device FLOPs for
    ``eff_flops``, HBM traffic bytes for ``hbm_bw``, ring-effective byte
    volumes for ``link_fast``/``link_slow``.  ``wall_s`` is the measured
    duration — real seconds on devices, simulated seconds under the fault
    injector.  ``kind`` is a label for reporting ("step", "compute",
    "collective", "kernel"); the fit only reads ``features``/``wall_s``.
    """
    kind: str
    group: str
    wall_s: float
    features: Mapping[str, float]
    step: int = -1


@dataclasses.dataclass(frozen=True)
class CalibratedHardware(Hardware):
    """A ``Hardware`` whose rate entries were re-fitted from observations.

    Drop-in everywhere a hand-written table is accepted (``step_cost``,
    ``prefill_time``, autotuning, placement search) — it *is* a
    ``Hardware``.  Extra fields record provenance: ``confidence`` maps each
    of ``CALIBRATION_PARAMS`` to a [0, 1] score (0 = parameter was not
    identifiable from the observations and sits at the prior; near 1 =
    tightly determined), ``n_observations`` the sample count, ``base_name``
    the prior table's name.
    """
    confidence: Mapping[str, float] = dataclasses.field(default_factory=dict)
    n_observations: int = 0
    base_name: str = ""


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------


def fit(observations: Sequence[Observation], base: Hardware, *,
        name: str | None = None, ridge: float = 1e-4) -> CalibratedHardware:
    """Least-squares re-fit of ``base``'s rate entries from observations.

    Solves ``min_x Σ_i ((a_i·x − t_i)/t_i)² + Σ_j λ_j (x_j − x0_j)²`` where
    row i holds observation i's feature coefficients and ``x0`` the prior
    reciprocals from ``base``.  Residuals are *relative* (each row scaled
    by 1/t_i): timing jitter is multiplicative, and without the weighting a
    microsecond kernel observation is invisible next to a second-long step.
    The per-column ridge weight ``λ_j = ridge · ||A_:j||²`` (computed on
    the weighted matrix) is scale-free: it only matters for directions the
    data barely constrains, pulling them to the prior instead of letting
    the solve blow up.

    Confidence per parameter is ``clip(1 − se_j / x_j, 0, 1) · n_j/(n_j+2)``
    with ``se_j`` the standard error from the residual variance and ``n_j``
    the number of observations touching the parameter — 0 for columns with
    no observations at all (kept exactly at the prior).
    """
    params = CALIBRATION_PARAMS
    x0 = np.array([hardware_reciprocals(base)[p] for p in params])
    obs = [o for o in observations if o.wall_s > 0.0]
    if not obs:
        return _build(base, x0, {p: 0.0 for p in params}, 0, name)

    raw = np.array([[float(o.features.get(p, 0.0)) for p in params]
                    for o in obs])
    t_raw = np.array([float(o.wall_s) for o in obs])
    A = raw / t_raw[:, None]       # relative residuals: each row / t_i
    t = np.ones_like(t_raw)

    col_sq = (A * A).sum(axis=0)
    seen = col_sq > 0.0
    lam = ridge * col_sq  # scale-free per-column ridge weight

    # Augmented rows implement the ridge-to-prior penalty exactly.
    sqrt_lam = np.sqrt(lam[seen])
    As = np.concatenate([A[:, seen], np.diag(sqrt_lam)], axis=0)
    ts = np.concatenate([t, sqrt_lam * x0[seen]])
    sol, *_ = np.linalg.lstsq(As, ts, rcond=None)

    x = x0.copy()
    x[seen] = sol
    # A non-positive reciprocal is unphysical (negative rate); noise can
    # produce one only for barely-constrained columns — snap to prior.
    bad = x <= 0.0
    x[bad] = x0[bad]

    n, k = A[:, seen].shape
    resid = A[:, seen] @ x[seen] - t
    sigma2 = float(resid @ resid) / max(n - k, 1)
    gram = A[:, seen].T @ A[:, seen] + np.diag(lam[seen])
    try:
        cov = sigma2 * np.linalg.inv(gram)
        se = np.sqrt(np.clip(np.diag(cov), 0.0, None))
    except np.linalg.LinAlgError:  # pragma: no cover - gram is PD by ridge
        se = np.full(k, np.inf)

    # per-column sample counts, for the small-sample confidence discount:
    # with 3 observations the residual variance estimate is itself noisy,
    # so the standard error alone overstates certainty.
    n_col = (A != 0.0).sum(axis=0)
    confidence = {}
    ji = 0
    for j, p in enumerate(params):
        if not seen[j] or bad[j]:
            confidence[p] = 0.0
        else:
            c = float(np.clip(1.0 - se[ji] / x[j], 0.0, 1.0))
            confidence[p] = c * n_col[j] / (n_col[j] + 2.0)
        if seen[j]:
            ji += 1
    return _build(base, x, confidence, len(obs), name)


def _build(base: Hardware, x: np.ndarray, confidence: Mapping[str, float],
           n_obs: int, name: str | None) -> CalibratedHardware:
    by = dict(zip(CALIBRATION_PARAMS, (float(v) for v in x)))
    link_bw = dict(base.link_bw)
    link_bw["fast"] = 1.0 / by["link_fast"]
    link_bw["slow"] = 1.0 / by["link_slow"]
    return CalibratedHardware(
        name=name or base.name,
        # the fit sees only the effective rate peak·mxu_eff; report it as
        # peak_flops holding mxu_eff at the prior so consumers that form
        # peak_flops·mxu_eff recover exactly the fitted effective rate.
        peak_flops=(1.0 / by["eff_flops"]) / base.mxu_eff,
        hbm_bw=1.0 / by["hbm_bw"],
        hbm_bytes=base.hbm_bytes,
        link_bw=link_bw,
        mxu_eff=base.mxu_eff,
        vmem_bytes=base.vmem_bytes,
        axis_kind=dict(base.axis_kind),
        confidence=dict(confidence),
        n_observations=n_obs,
        base_name=base.name if not isinstance(base, CalibratedHardware)
        else (base.base_name or base.name),
    )


# ---------------------------------------------------------------------------
# evaluation helpers
# ---------------------------------------------------------------------------


def prediction_error(observations: Sequence[Observation],
                     hw: Hardware) -> float:
    """Mean relative |predicted − measured| / measured over observations."""
    errs = [abs(predict_step_time(o.features, hw) - o.wall_s) / o.wall_s
            for o in observations if o.wall_s > 0.0]
    return float(np.mean(errs)) if errs else float("inf")


def parameter_error(fitted: Hardware, truth: Hardware,
                    params: Sequence[str] = CALIBRATION_PARAMS) -> float:
    """Max relative error of fitted rates vs a ground-truth table.

    Compared in rate space (effective FLOP/s, bytes/s) — the quantities the
    cost model actually consumes — so a ``CalibratedHardware`` that moved
    ``peak_flops`` while holding ``mxu_eff`` at the prior is judged on the
    product.
    """
    rf, rt = hardware_reciprocals(fitted), hardware_reciprocals(truth)
    return max(abs(1.0 / rf[p] - 1.0 / rt[p]) / (1.0 / rt[p])
               for p in params)


def refit_spec(spec: ClusterSpec,
               fits: Mapping[str, Hardware]) -> ClusterSpec:
    """Swap fitted tables into a ``ClusterSpec`` by device-group name.

    Groups without an entry keep their prior table, so a partial fit (one
    group never produced observations) still yields a usable spec.
    """
    return ClusterSpec(groups=tuple(
        dataclasses.replace(g, hw=fits[g.name]) if g.name in fits else g
        for g in spec.groups))


# ---------------------------------------------------------------------------
# synthetic observations (round-trip tests, fig_calibration part (a))
# ---------------------------------------------------------------------------


def synthesize_observations(meta, strat, truth: Hardware, *,
                            n_steps: int = 32, overlap: float = 0.0,
                            noise: float = 0.0, seed: int = 0,
                            group: str | None = None,
                            kernel_bytes: float | None = None,
                            decomposed: bool = True) -> list[Observation]:
    """Observations drawn from the analytic formulas on ``truth`` (+ noise).

    The round-trip test input: ``fit`` over these must recover ``truth``'s
    rates.  ``decomposed=True`` emits what a real profiler sees — separate
    compute, per-link collective, and HBM-bound kernel timings per step —
    which makes every parameter identifiable.  ``decomposed=False`` emits
    only whole-step times (collinear: the fit can then only be judged on
    *predictions*, not per-parameter recovery).  Multiplicative Gaussian
    noise models jitter; ``kernel_bytes`` defaults to one layer's
    activation traffic.
    """
    feats = step_cost_features(meta, strat, truth, overlap=overlap)
    recips = hardware_reciprocals(truth)
    gname = group or truth.name
    kb = float(kernel_bytes if kernel_bytes is not None
               else meta.act_bytes_per_layer)
    rng = np.random.default_rng(seed)

    def jit() -> float:
        return max(1.0 + noise * float(rng.standard_normal()), 0.05)

    out: list[Observation] = []
    for s in range(n_steps):
        if not decomposed:
            out.append(Observation("step", gname,
                                   predict_step_time(feats, truth) * jit(),
                                   dict(feats), s))
            continue
        comp = {"eff_flops": feats["eff_flops"]}
        out.append(Observation("compute", gname,
                               feats["eff_flops"] * recips["eff_flops"]
                               * jit(), comp, s))
        for p in ("link_fast", "link_slow"):
            if feats[p] > 0.0:
                out.append(Observation("collective", gname,
                                       feats[p] * recips[p] * jit(),
                                       {p: feats[p]}, s))
        if kb > 0.0:
            out.append(Observation("kernel", gname, kb * recips["hbm_bw"]
                                   * jit(), {"hbm_bw": kb}, s))
    return out
