"""The port's calibration loop (``repro_torch.core.calibrate``,
``runtime/profiler.py``, ``runtime/straggler.py``) and the train driver's
``--profile`` against the reference (``repro``) on the CPU.

Pure Python and numpy in both packages: the synthetic observations (the
same ``np.random.default_rng(seed)`` draws), the least-squares fits, the
calibration report's text and the straggler flags are held equal with
``==``.  The H100 table's peaks are held equal to the constants behind
``chip_smoke.py``'s kernel bounds.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import calibrate as ref_cal
from repro.core import cost_model as ref_cm
from repro.models import lm as ref_lm
from repro.runtime import profiler as ref_prof
from repro.runtime import straggler as ref_strag
from repro_torch.core import calibrate as cal
from repro_torch.core import cost_model as cm
from repro_torch.launch import train
from repro_torch.runtime import profiler as prof
from repro_torch.runtime import straggler as strag

from torch_harness import data, outcome, to_port

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(ref_cal, cal), (ref_prof, prof), (ref_strag, strag)]


@pytest.mark.parametrize("ref_mod,port_mod", PAIRS,
                         ids=[p[1].__name__ for p in PAIRS])
def test_modules_mirror_the_reference_names_and_fields(ref_mod, port_mod):
    """Every public name is ported (``Profiler.record_hlo`` waits for the
    HLO analysis), every dataclass has the reference's fields in order."""
    for name in getattr(ref_mod, "__all__", None) or [
            n for n, o in vars(ref_mod).items() if not n.startswith("_")
            and getattr(o, "__module__", None) == ref_mod.__name__]:
        obj = getattr(ref_mod, name)
        assert hasattr(port_mod, name), name
        if dataclasses.is_dataclass(obj):
            assert [(f.name, f.default) for f in dataclasses.fields(
                getattr(port_mod, name))] == [
                (f.name, f.default) for f in dataclasses.fields(obj)], name
        if isinstance(obj, type):
            missing = {m for m in vars(obj) if not m.startswith("_")} - set(
                vars(getattr(port_mod, name)))
            assert missing == ({"record_hlo"} if name == "Profiler"
                               else set()), name


def _meta_pair(batch=256, seq=512, arch="tinyllama-1.1b"):
    rmeta = ref_lm.model_graph(jax_get_config(arch), batch,
                               seq).workload_meta()
    return rmeta, to_port(rmeta)


STRATS = [dict(dp=4, tp=2), dict(dp=8), dict(dp=2, tp=2, pp=2,
                                             micro_batches=4),
          dict(dp=8, zero=3), dict()]


@pytest.mark.parametrize("seed", range(5))
def test_fit_on_synthesized_observations_agrees(seed):
    """``synthesize_observations`` (decomposed and whole-step, with and
    without noise) gives the same observations bit for bit; ``fit``,
    ``prediction_error``, ``parameter_error`` and ``refit_spec`` agree."""
    rmeta, meta = _meta_pair()
    for kw in STRATS:
        rs, s = ref_cm.StrategySpec(**kw), cm.StrategySpec(**kw)
        for rtruth, truth in ((ref_cm.V100_PAPER, cm.V100_PAPER),
                              (ref_cm.TPU_V5E, cm.TPU_V5E)):
            for decomposed in (True, False):
                for noise in (0.0, 0.05):
                    robs = ref_cal.synthesize_observations(
                        rmeta, rs, rtruth, n_steps=12, noise=noise,
                        seed=seed, decomposed=decomposed, overlap=0.25)
                    obs = cal.synthesize_observations(
                        meta, s, truth, n_steps=12, noise=noise, seed=seed,
                        decomposed=decomposed, overlap=0.25)
                    assert data(obs) == data(robs)
                    for rbase, base in ((ref_cm.T4_16G, cm.T4_16G),
                                        (rtruth, truth)):
                        rfit = ref_cal.fit(robs, rbase)
                        got = cal.fit(obs, base)
                        assert data(got) == data(rfit)
                        assert cal.prediction_error(obs, got) == \
                            ref_cal.prediction_error(robs, rfit)
                        assert cal.prediction_error(obs, base) == \
                            ref_cal.prediction_error(robs, rbase)
                        assert cal.parameter_error(got, truth) == \
                            ref_cal.parameter_error(rfit, rtruth)
                    # a fit of a fit keeps the first table's name
                    assert data(cal.fit(obs, cal.fit(obs, truth),
                                        name="again")) == \
                        data(ref_cal.fit(robs, ref_cal.fit(robs, rtruth),
                                         name="again"))
    assert data(cal.fit([], cm.T4_16G)) == data(ref_cal.fit([],
                                                            ref_cm.T4_16G))
    assert cal.prediction_error([], cm.T4_16G) == math.inf
    rspec = ref_cm.ClusterSpec(groups=(
        ref_cm.DeviceGroup("a", ref_cm.V100_PAPER, 8),
        ref_cm.DeviceGroup("b", ref_cm.T4_16G, 8)))
    spec = to_port(rspec)
    robs = ref_cal.synthesize_observations(
        rmeta, ref_cm.StrategySpec(dp=8), ref_cm.V100_PAPER, seed=seed,
        noise=0.02, group="a")
    obs = cal.synthesize_observations(meta, cm.StrategySpec(dp=8),
                                      cm.V100_PAPER, seed=seed, noise=0.02,
                                      group="a")
    assert data(cal.refit_spec(spec, {"a": cal.fit(obs, cm.V100_PAPER)})) \
        == data(ref_cal.refit_spec(rspec, {"a": ref_cal.fit(
            robs, ref_cm.V100_PAPER)}))


def _record_both(seed: int):
    """The same observations recorded into a reference and a port
    Profiler: whole steps against a strategy's features, compute, every
    collective kind and kernels, over two groups, past the window."""
    rng = np.random.default_rng(seed)
    rmeta, meta = _meta_pair()
    feats = cm.step_cost_features(meta, cm.StrategySpec(dp=4, tp=2),
                                  cm.H100_SXM)
    pair = (ref_prof.Profiler(max_per_group=40),
            prof.Profiler(max_per_group=40))
    kinds = sorted(ref_prof._RING)
    for step in range(30):
        t = float(rng.uniform(0.1, 0.5))
        k = kinds[step % len(kinds)]
        payload, n = float(rng.uniform(1e6, 1e9)), int(rng.integers(1, 9))
        link = ("fast", "slow")[step % 2]
        f = float(rng.uniform(1e12, 1e14))
        hb = float(rng.uniform(1e8, 1e10))
        for p in pair:
            p.record_step("h100", t, feats, step=step)
            p.record_compute("v100", t / 3, f, step=step)
            p.record_collective("v100", k, payload, n, t / 5, link=link,
                                step=step)
            p.record_kernel("v100", hb, t / 7, step=step)
            p.record_kernel("v100", 0.0, t, step=step)      # ignored
            p.record_step("h100", 0.0, feats, step=step)    # ignored
    return pair


@pytest.mark.parametrize("seed", range(3))
def test_profiler_report_and_fits_agree(seed):
    ref, port = _record_both(seed)
    assert port.groups == ref.groups and port.n_obs() == ref.n_obs()
    for g in ref.groups:
        assert port.n_obs(g) == ref.n_obs(g)
        for last_n in (None, 5):
            assert data(port.window(g, last_n)) == data(ref.window(g, last_n))
    hws = (("h100", cm.H100_SXM, ref_cm.Hardware(**dataclasses.asdict(
        cm.H100_SXM))), ("v100", cm.V100_PAPER, ref_cm.V100_PAPER))
    spec = cm.ClusterSpec(groups=tuple(cm.DeviceGroup(n, hw, 4)
                                       for n, hw, _ in hws)
                          + (cm.DeviceGroup("idle", cm.T4_16G, 4),))
    rspec = ref_cm.ClusterSpec(groups=tuple(
        ref_cm.DeviceGroup(n, rhw, 4) for n, _, rhw in hws)
        + (ref_cm.DeviceGroup("idle", ref_cm.T4_16G, 4),))
    for last_n in (None, 8):
        assert port.report(spec, last_n=last_n) == \
            ref.report(rspec, last_n=last_n)
        got_spec, got = port.fit_spec(spec, last_n=last_n)
        want_spec, want = ref.fit_spec(rspec, last_n=last_n)
        assert data(got_spec) == data(want_spec) and data(got) == data(want)
    for name, hw, rhw in hws:
        assert port.error(name, hw) == ref.error(name, rhw)
        assert data(port.fit_group(name, hw, ridge=1e-2)) == \
            data(ref.fit_group(name, rhw, ridge=1e-2))
    for p in (ref, port):
        p.clear("v100")
    assert port.groups == ref.groups == ("h100",)
    for p in (ref, port):
        p.clear()
    assert port.n_obs() == ref.n_obs() == 0


def test_ring_effective_bytes_agree():
    for kind in sorted(ref_prof._RING) + ["broadcast"]:
        for b in (0.0, 1.0, 3.5e9):
            for n in (1, 2, 4, 64):
                assert outcome(prof.ring_effective_bytes, kind, b, n) == \
                    outcome(ref_prof.ring_effective_bytes, kind, b, n)


def _step_times(seed: int, n: int = 120) -> list:
    """Seeded step times (0.4 s, 3% jitter) with injected slow runs: one
    isolated spike, a run of 2, and two sustained 3-step and 5-step
    stragglers at 1.5x and 2x."""
    rng = np.random.default_rng(seed)
    t = 0.4 * (1.0 + 0.03 * rng.standard_normal(n))
    t[0] = 3.0                                 # the first step compiles
    for lo, hi, f in ((20, 21, 2.0), (35, 37, 1.7), (50, 53, 1.5),
                      (80, 85, 2.0)):
        t[lo:hi] *= f
    return [float(x) for x in t]


@pytest.mark.parametrize("seed", range(4))
def test_straggler_flags_agree(seed):
    times = _step_times(seed)
    for kw in ({}, {"patience": 2, "warmup": 3}, {"threshold": 1.5},
               {"ema_decay": 0.5, "patience": 1}):
        ref, port = ref_strag.StragglerMonitor(**kw), \
            strag.StragglerMonitor(**kw)
        flags = []
        for i, dt in enumerate(times):
            got, want = port.observe(dt), ref.observe(dt)
            assert got == want
            flags.append(got)
            if got:                       # the driver's policy: re-arm
                port.reset()
                ref.reset()
            assert (port.mean, port.var, port.n, port.consecutive,
                    port.flagged) == (ref.mean, ref.var, ref.n,
                                      ref.consecutive, ref.flagged)
            if i == 90:
                port.reset(clear_stats=True)
                ref.reset(clear_stats=True)
        if not kw:
            assert any(flags[80:86]), flags   # the sustained 2x straggler
    # the controller's per-host view: flags, eviction, admission, reset
    ref, port = ref_strag.HostStragglerAggregator(n_hosts=4, patience=2), \
        strag.HostStragglerAggregator(n_hosts=4, patience=2)
    for step, dt in enumerate(times):
        host_times = {h: dt * (1.0 + 0.01 * h) for h in range(4)}
        if step >= 60:
            host_times[2] *= 3.0
        got, want = port.observe(host_times), ref.observe(host_times)
        assert got == want
        for h in got:
            port.evict(h)
            ref.evict(h)
        if step == 100:
            for a in (port, ref):
                a.admit(2)
                a.reset()
        assert port.evicted == ref.evicted
        assert sorted(port.monitors) == sorted(ref.monitors)


def test_h100_table_peaks_equal_chip_smoke_bounds():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PEAK_BYTES_PER_S == cm.H100_SXM.hbm_bw
    assert smoke.PEAK_FLOPS["torch.bfloat16"] == cm.H100_SXM.peak_flops


# ---------------------------------------------------------------------------
# the train driver's --profile
# ---------------------------------------------------------------------------

SMOKE = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
         "--log-every", "1", "--steps", "3"]


def test_train_driver_profile_prints_the_report_and_keeps_the_losses(
        tmp_path, capsys):
    """``--auto --hw h100 --profile`` prints the choice and the report;
    the losses are the plain run's; the profile holds one observation per
    step after the first, and its report is the reference Profiler's on
    the same observations."""
    plain = train.main(SMOKE + ["--ckpt-dir", str(tmp_path / "a")])
    capsys.readouterr()
    out = train.main(SMOKE + ["--auto", "--hw", "h100", "--profile",
                              "--ckpt-dir", str(tmp_path / "b")])
    text = capsys.readouterr().out
    assert out["losses"] == plain["losses"]
    assert out["strategy"] == plain["strategy"] == "single-device"
    assert "[auto] chose: single-device\n" in text
    assert "[plan] single-device on 1 x h100: predicted step" in text
    p = out["profile"]
    assert p["observations"] == 2 and p["hw"] == "h100"
    assert p["report"] in text and "calibration report" in p["report"]
    assert f"{p['error_before']:.3f} on the table, " \
           f"{p['error_after']:.3f} after the fit" in text
    assert math.isfinite(p["error_after"]) and p["error_before"] > 0.0
    # only the compute rate is seen by whole-step single-device steps
    assert p["confidence"]["link_fast"] == p["confidence"]["hbm_bw"] == 0.0
    assert p["rates"]["hbm_bw"] == p["prior_rates"]["hbm_bw"] == 3.35e12

    rmeta = ref_lm.model_graph(jax_get_config("tinyllama-1.1b", smoke=True),
                               2, 32).workload_meta()
    rhw = ref_cm.Hardware(**dataclasses.asdict(cm.H100_SXM))
    rfeats = ref_cm.step_cost_features(rmeta, ref_cm.StrategySpec(), rhw)
    ref = ref_prof.Profiler()
    for i, dt in enumerate(out["step_seconds"][1:], start=1):
        ref.record_step("h100", dt, rfeats, step=i)
    assert p["report"] == ref.report(ref_cm.ClusterSpec.homogeneous(rhw, 1))
    assert p["error_before"] == ref.error("h100", rhw)
    assert out["predicted_step_s"] == ref_cm.step_cost(
        rmeta, ref_cm.StrategySpec(), rhw).total
    assert "profile" not in plain
