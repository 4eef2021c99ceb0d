"""The port's prefill/decode router and analytic serving simulator
(``repro_torch.serving.router``, ``repro_torch.serving.sim``) against the
reference's (``repro.serving``) on the CPU.

Both are pure Python over the cost model, ``hetero``, ``metrics`` and
``traffic`` in each package, so every result is held equal with ``==``:
every priced partition, the chosen route and its error, and the
simulator's whole report on tests/test_serving.py's 400-request scenario.
The H100 table has no reference twin: the reference prices it as data (a
reference ``Hardware`` built from its fields).
"""
import dataclasses
import inspect
import itertools

import pytest

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as ref_cm
from repro.core import hetero as ref_het
from repro.serving import router as ref_router
from repro.serving import sim as ref_sim
from repro.serving import traffic as ref_traffic
import repro.serving as ref_serving
from repro_torch.configs import get_config
from repro_torch.core import cost_model as cm
from repro_torch.core import hetero
from repro_torch.serving import router, sim, traffic
import repro_torch.serving as serving

from torch_harness import data, outcome

ARCH = "tinyllama-1.1b"
SHAPE = dict(mean_prompt=64, mean_gen=64, page_size=64, batch_slots=16)


def _h100(m):
    if m is cm:
        return cm.H100_SXM
    return m.Hardware(**{f.name: getattr(cm.H100_SXM, f.name)
                         for f in dataclasses.fields(cm.H100_SXM)})


def _specs(m):
    """tests/test_serving.py's mixed spec, and one with an H100 group."""
    G = m.DeviceGroup
    return {"v100+t4": m.ClusterSpec(groups=(G("8xv100", m.V100_PAPER, 8),
                                             G("8xt4", m.T4_16G, 8))),
            "h100+v100+t4": m.ClusterSpec(groups=(
                G("2xh100", _h100(m), 2), G("8xv100", m.V100_PAPER, 8),
                G("8xt4", m.T4_16G, 8)))}


def _metas():
    return (cm.lm_serving_meta(get_config(ARCH)),
            ref_cm.lm_serving_meta(jax_get_config(ARCH)))


@pytest.mark.parametrize("ref_mod,port_mod", [
    (ref_router, router), (ref_sim, sim), (ref_serving, serving)],
    ids=["router", "sim", "serving"])
def test_modules_mirror_the_reference_names_and_fields(ref_mod, port_mod):
    for name, obj in vars(ref_mod).items():
        if inspect.ismodule(obj) or name.startswith("__"):
            continue
        assert hasattr(port_mod, name), name
        if dataclasses.is_dataclass(obj):
            got = [(f.name, f.default) for f in
                   dataclasses.fields(getattr(port_mod, name))]
            assert got == [(f.name, f.default)
                           for f in dataclasses.fields(obj)], name
    assert getattr(port_mod, "__all__", None) == \
        getattr(ref_mod, "__all__", None)


@pytest.mark.parametrize("name", ["v100+t4", "h100+v100+t4"])
def test_every_partition_and_the_route_match_reference(name):
    meta, rmeta = _metas()
    assert data(meta) == data(rmeta)
    spec, rspec = _specs(cm)[name], _specs(ref_cm)[name]
    names = [g.name for g in spec.groups]
    n = 0
    for r in range(1, len(names)):
        for picked in itertools.combinations(names, r):
            pf, dc = hetero.partition_cluster(spec, picked)
            rpf, rdc = ref_het.partition_cluster(rspec, picked)
            for kw in (SHAPE, dict(SHAPE, reserve=0.5, batch_slots=64)):
                got = router.price_partition(meta, pf, dc, **kw)
                want = ref_router.price_partition(rmeta, rpf, rdc, **kw)
                assert data(got) == data(want), picked
                assert (got.request_rate, got.describe()) == \
                    (want.request_rate, want.describe())
                n += 1
    assert n == 2 * (2 ** len(names) - 2)
    for kw in (SHAPE, dict(SHAPE, mean_prompt=500, mean_gen=16)):
        assert outcome(router.route, meta, spec, **kw) == \
            outcome(ref_router.route, rmeta, rspec, **kw)
    assert router._cross_pool_bw(*hetero.partition_cluster(
        spec, names[:1])) == ref_router._cross_pool_bw(
        *ref_het.partition_cluster(rspec, names[:1]))


def test_route_refuses_a_single_group():
    meta, rmeta = _metas()
    got = outcome(router.route, meta, cm.ClusterSpec.homogeneous(
        cm.V100_PAPER, 8), **SHAPE)
    assert got[0] == "raised" and got[1] == "ValueError"
    assert got == outcome(ref_router.route, rmeta,
                          ref_cm.ClusterSpec.homogeneous(ref_cm.V100_PAPER,
                                                         8), **SHAPE)


def test_compare_matches_reference_on_the_400_request_scenario():
    """tests/test_serving.py::test_sim_conserves_requests_and_flagship_wins:
    the offered rate 0.8x the routed plan's, 400 requests."""
    meta, rmeta = _metas()

    def scenario(m, tr, spec, plan):
        return m.ServeScenario(
            name="t", spec=spec,
            traffic=tr.TrafficCfg(rate=0.8 * plan.request_rate,
                                  n_requests=400, gen_lens=(32, 64, 128)),
            batch_slots=64, page_size=64, max_len=4096)

    kw = dict(mean_prompt=60, mean_gen=74, page_size=64, batch_slots=64)
    spec, rspec = _specs(cm)["v100+t4"], _specs(ref_cm)["v100+t4"]
    plan = router.route(meta, spec, **kw)
    rplan = ref_router.route(rmeta, rspec, **kw)
    assert data(plan) == data(rplan)
    got = sim.compare(meta, scenario(sim, traffic, spec, plan))
    want = ref_sim.compare(rmeta, scenario(ref_sim, ref_traffic, rspec,
                                           rplan))
    assert got == want
    assert got["colocated"]["completed"] == got["disagg"]["completed"] == 400
    assert got["tokens_per_s_ratio"] > 1.0
