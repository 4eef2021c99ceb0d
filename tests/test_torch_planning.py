"""The port's planning layer (``repro_torch.core``: cost model, schedules,
heterogeneous balancing, auto-search; ``models/lm.py::model_graph``; the
planner's cluster checks; the train driver's ``--auto``) against the
reference (``repro``) on the CPU.

These modules are pure Python and numpy in both packages, so every result
is held equal with ``==``, not within a tolerance.  The reference's
dataclasses (hardware tables, graphs, strategies, cluster specs) are
carried across as data (``torch_harness.to_port``), so both sides price
the same inputs; the port's own graphs of every config, the multimodal
and encoder-decoder families' included, are held against the
reference's.
"""
import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import ARCH_NAMES as REF_ARCHS
from repro.configs import get_config as jax_get_config
from repro.core import auto as ref_auto
from repro.core import cost_model as ref_cm
from repro.core import hetero as ref_het
from repro.core import schedule as ref_sch
from repro.models import lm as ref_lm
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import auto, cost_model as cm, hetero, planner
from repro_torch.core import schedule as sch
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.models.convert import leaf_paths

from torch_harness import data, outcome, to_port

ROOT = Path(__file__).resolve().parents[1]
TABLES = ("TPU_V5E", "V100_PAPER", "P100_16G", "T4_16G")
# the H100 table has no reference twin: the reference's functions price it
# as data (a reference Hardware built from its fields)
ALL_TABLES = TABLES + ("H100_SXM",)


def _tables(name: str):
    """(reference table, port table) by name."""
    port = getattr(cm, name)
    ref = getattr(ref_cm, name) if name in TABLES else ref_cm.Hardware(
        **{f.name: getattr(port, f.name) for f in dataclasses.fields(port)})
    return ref, port


def _ref_graph(arch: str, batch: int = 8, seq: int = 512):
    return ref_lm.model_graph(jax_get_config(arch), batch, seq)


# ---------------------------------------------------------------------------
# the port mirrors the reference's names, fields and tables
# ---------------------------------------------------------------------------

PAIRS = [(ref_cm, cm), (ref_sch, sch), (ref_het, hetero), (ref_auto, auto)]


@pytest.mark.parametrize("ref_mod,port_mod", PAIRS,
                         ids=[p[1].__name__ for p in PAIRS])
def test_modules_mirror_the_reference_names_and_fields(ref_mod, port_mod):
    """Every public name of the reference module is in the port
    (``graph_from_taskgraph`` too, since the TaskGraph IR is ported);
    every dataclass has the reference's fields in the reference's order
    (the tests rebuild the port's objects from the reference's fields)."""
    for name, obj in vars(ref_mod).items():
        if name.startswith("_") or inspect.ismodule(obj) \
                or getattr(obj, "__module__", ref_mod.__name__) \
                != ref_mod.__name__:
            continue
        assert hasattr(port_mod, name), name
        if dataclasses.is_dataclass(obj):
            got = [(f.name, f.default) for f in
                   dataclasses.fields(getattr(port_mod, name))]
            assert got == [(f.name, f.default)
                           for f in dataclasses.fields(obj)], name
    assert callable(auto.graph_from_taskgraph)


@pytest.mark.parametrize("name", TABLES)
def test_reference_tables_are_unchanged(name):
    ref, port = _tables(name)
    assert data(port) == data(ref)
    assert port.flops_per_hbm_byte == ref.flops_per_hbm_byte


def test_h100_table_is_the_datasheet_card():
    """dense bf16 989 TFLOP/s, HBM3 3.35 TB/s and 80 GB, 228 KiB shared
    memory per SM, NVLink 4 450 GB/s a direction, 50 GB/s between servers;
    the pod axis on the slow link, as TPU_V5E's."""
    h = cm.H100_SXM
    assert (h.name, h.peak_flops, h.hbm_bw, h.hbm_bytes, h.vmem_bytes,
            h.mxu_eff) == ("h100", 989e12, 3.35e12, 80e9, 228 * 2**10, 0.55)
    assert h.link_bw == {"fast": 450e9, "slow": 50e9}
    assert dict(h.axis_kind) == dict(ref_cm.TPU_V5E.axis_kind)
    assert h.bw_for_axis("pod") == 50e9 and h.bw_for_axis("data") == 450e9


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ALL_TABLES)
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_step_cost_agrees_on_every_enumerated_strategy(arch, table):
    """The ten reference configs' graphs at batch 8 x seq 512, carried
    across as data: the same strategies at 1, 8 and 64 devices, and for
    each ``step_cost``, ``step_cost_features``, ``predict_step_time`` and
    ``throughput`` (overlap 0 and 0.5)."""
    ref_hw, hw = _tables(table)
    rg = _ref_graph(arch)
    g = to_port(rg)
    assert data(g) == data(rg)
    rmeta, meta = rg.workload_meta(), g.workload_meta()
    assert data(meta) == data(rmeta)
    assert cm.hardware_reciprocals(hw) == ref_cm.hardware_reciprocals(ref_hw)
    for n in (1, 8, 64):
        rstrats = ref_auto.enumerate_strategies(rg, n)
        strats = auto.enumerate_strategies(g, n)
        assert data(strats) == data(rstrats)
        for rs, s in zip(rstrats, strats):
            assert s.describe() == rs.describe()
            for ov in (0.0, 0.5):
                assert data(cm.step_cost(meta, s, hw, overlap=ov)) == \
                    data(ref_cm.step_cost(rmeta, rs, ref_hw, overlap=ov))
                f = cm.step_cost_features(meta, s, hw, overlap=ov)
                assert f == ref_cm.step_cost_features(rmeta, rs, ref_hw,
                                                      overlap=ov)
                assert cm.predict_step_time(f, hw) == \
                    ref_cm.predict_step_time(f, ref_hw)
                assert cm.throughput(meta, s, hw, overlap=ov) == \
                    ref_cm.throughput(rmeta, rs, ref_hw, overlap=ov)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_model_graph_methods_agree(arch):
    """Segment structure, spans, partitions and per-stage views — the
    branches of the MoE, multimodal and encoder-decoder graphs too."""
    rg = _ref_graph(arch)
    g = to_port(rg)
    L = g.n_layers
    assert g.boundaries() == rg.boundaries()
    assert g.segment_spans() == rg.segment_spans()
    assert g.layer_costs() == rg.layer_costs()
    assert g.describe() == rg.describe()
    assert cm.as_workload_meta(g) == to_port(ref_cm.as_workload_meta(rg))
    for pp in range(0, 9):
        assert g.feasible_pp(pp) == rg.feasible_pp(pp)
    for lo in range(0, L + 1, max(1, L // 12)):
        for hi in range(lo, L + 2, max(1, L // 7)):
            assert g.valid_span(lo, hi) == rg.valid_span(lo, hi)
            for pp in (1, 2, 4):
                assert outcome(g.stage_meta, lo, hi, pp) == \
                    outcome(rg.stage_meta, lo, hi, pp)
    for counts in ([L], [1, L - 1], [L - 1, 1], [L // 2, L - L // 2]):
        assert g.valid_partition(counts) == rg.valid_partition(counts)


def test_segment_and_graph_checks_raise_as_the_reference():
    for kw in ({"n_layers": 0}, {"n_layers": 2, "n_moe_layers": 3}):
        args = dict(name="s", fwd_flops=1.0, param_bytes=1.0,
                    act_bytes_per_layer=1.0, **kw)
        with pytest.raises(ValueError) as want:
            ref_cm.SegmentMeta(**args)
        with pytest.raises(ValueError, match=str(want.value)):
            cm.SegmentMeta(**args)
    with pytest.raises(ValueError, match="at least one segment"):
        cm.ModelGraph(name="g", segments=(), batch=1)
    with pytest.raises(ValueError, match="at least one DeviceGroup"):
        cm.ClusterSpec(groups=())
    for kw in ({"ep": 0}, {"ep": 2, "tp": 4}):
        with pytest.raises(ValueError) as want:
            ref_cm.StrategySpec(**kw)
        with pytest.raises(ValueError, match=str(want.value)):
            cm.StrategySpec(**kw)


def test_collective_formulas_agree():
    for fn in ("all_reduce_time", "all_gather_time", "reduce_scatter_time",
               "all_to_all_time"):
        for b in (0.0, 1.0, 3e9, 7.25e11):
            for n in (0, 1, 2, 3, 8, 64):
                for bw in (1.0, 6.25e9, 450e9):
                    assert getattr(cm, fn)(b, n, bw) == \
                        getattr(ref_cm, fn)(b, n, bw)
    assert cm.p2p_time(3e9, 7e9) == ref_cm.p2p_time(3e9, 7e9)


SERVING = [("tinyllama-1.1b", False), ("tinyllama-1.1b", True),
           ("mamba2-1.3b", False), ("mamba2-1.3b", True)]


@pytest.mark.parametrize("arch,smoke", SERVING)
def test_serving_functions_agree(arch, smoke):
    """``lm_serving_meta`` of the port's config equals the reference's of
    its own, and prefill, decode, KV hand-off and page budget agree on
    every table."""
    rmeta = ref_cm.lm_serving_meta(jax_get_config(arch, smoke=smoke))
    meta = cm.lm_serving_meta(get_config(arch, smoke=smoke))
    assert data(meta) == data(rmeta)
    for table in ALL_TABLES:
        ref_hw, hw = _tables(table)
        for n in (1, 8):
            rgrp, grp = ref_cm.DeviceGroup(table, ref_hw, n), \
                cm.DeviceGroup(table, hw, n)
            for prompt in (1, 500, 2048):
                for b in (1, 8):
                    assert cm.prefill_time(meta, grp, prompt, b) == \
                        ref_cm.prefill_time(rmeta, rgrp, prompt, b)
            for active in (0, 1, 8):
                for ctx in (0, 4782, 8 * 1024.0):
                    assert cm.decode_step_time(meta, grp, active, ctx) == \
                        ref_cm.decode_step_time(rmeta, rgrp, active, ctx)
            for page in (16, 64):
                for reserve in (0.2, 0.5):
                    # mamba2 keeps no KV: both divide by zero bytes
                    assert outcome(cm.serving_page_budget, meta, grp, page,
                                   reserve=reserve) == \
                        outcome(ref_cm.serving_page_budget, rmeta, rgrp,
                                page, reserve=reserve)
        assert cm.kv_handoff_time(meta, 500, hw.link_bw["slow"]) == \
            ref_cm.kv_handoff_time(rmeta, 500, ref_hw.link_bw["slow"])


# ---------------------------------------------------------------------------
# models/lm.py: the cost model's view of the port's configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", (False, True), ids=("full", "smoke"))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_graph_of_the_port_configs_equals_reference(arch, smoke):
    cfg, rcfg = get_config(arch, smoke=smoke), jax_get_config(arch,
                                                              smoke=smoke)
    model = lm.Model(cfg, "cpu")
    for batch, seq in ((8, 512), (4, 2048), (1, 1), (3, 77)):
        for adb, pdb in ((2, 4), (4, 2)):
            rg = ref_lm.model_graph(rcfg, batch, seq, act_dtype_bytes=adb,
                                    param_dtype_bytes=pdb)
            g = lm.model_graph(cfg, batch, seq, act_dtype_bytes=adb,
                               param_dtype_bytes=pdb)
            assert data(g) == data(rg)
            assert data(model.graph(batch, seq, act_dtype_bytes=adb,
                                    param_dtype_bytes=pdb)) == data(rg)
            assert data(g.workload_meta()) == data(rg.workload_meta())
            L = g.n_layers
            for pp in (1, 2, L):
                for lo, hi in ((0, L), (0, max(1, L // pp)), (L - 1, L)):
                    assert data(g.stage_meta(lo, hi, pp)) == \
                        data(rg.stage_meta(lo, hi, pp))
    if cfg.family == "encdec":
        # the source length apart from the target's
        for batch, seq, src in ((4, 2048, 1024), (2, 77, 512), (1, 8, 1)):
            rg = ref_lm.model_graph(rcfg, batch, seq, src_seq=src)
            assert data(lm.model_graph(cfg, batch, seq, src_seq=src)) == \
                data(rg)
            assert data(model.graph(batch, seq, src_seq=src)) == data(rg)
            assert data(rg) != data(ref_lm.model_graph(rcfg, batch, seq))


def test_model_graph_raises_for_families_the_port_lacks():
    base = get_config("tinyllama-1.1b", smoke=True)
    # every family of the reference has its graph now (vlm and encdec
    # left this test with their models; their graphs are in ARCH_NAMES'
    # parametrisations above): an unknown one raises as the reference's
    for family in ("rnn", "encoder"):
        with pytest.raises(ValueError, match="unknown model family") as want:
            ref_lm.model_graph(dataclasses.replace(
                jax_get_config("tinyllama-1.1b", smoke=True),
                family=family), 2, 8)
        with pytest.raises(ValueError, match=str(want.value)):
            lm.model_graph(dataclasses.replace(base, family=family), 2, 8)


@pytest.mark.parametrize("smoke", (False, True), ids=("full", "smoke"))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_shapes_equal_reference(arch, smoke):
    """``Model.param_shapes``: every leaf of the reference's
    ``jax.eval_shape`` tree, by the weight bridge's leaf paths, with its
    shape and dtype, and nothing allocated."""
    import jax

    shapes = ref_lm.Model(jax_get_config(arch, smoke=smoke)).param_shapes()
    want = {p: (tuple(s.shape), str(s.dtype))
            for p, s in zip(_leaf_paths(shapes), jax.tree.leaves(shapes))}
    got = leaf_paths(lm.Model(get_config(arch, smoke=smoke),
                              "cpu").param_shapes())
    assert all(t.is_meta for t in got.values())
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in got.items()} == want


# ---------------------------------------------------------------------------
# pipeline schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", range(1, 9))
def test_schedules_agree(S):
    for M in range(1, 17):
        assert sch.bubble_fraction_closed_form(S, M) == \
            ref_sch.bubble_fraction_closed_form(S, M)
        for name in sch.SCHEDULE_NAMES:
            got, want = sch.make_schedule(name, S, M), \
                ref_sch.make_schedule(name, S, M)
            assert data(got) == data(want)
            assert got.bubble_fraction() == want.bubble_fraction()
            assert got.peak_in_flight() == want.peak_in_flight()
            assert got.per_stage_in_flight() == want.per_stage_in_flight()
            assert got.as_arrays() == want.as_arrays()
            assert list(got.slots()) == list(want.slots())
            assert sch.in_flight_micro_batches(S, M, name) == \
                ref_sch.in_flight_micro_batches(S, M, name)
            assert sch.make_schedule(got, S, M) is got


def test_schedule_errors_agree():
    calls = [("make_schedule", ("zigzag", 2, 2)),
             ("make_schedule", ("gpipe", 0, 2)),
             ("make_schedule", ("1f1b", 2, 0)),
             ("in_flight_micro_batches", (2, 2, "zigzag")),
             ("gpipe_schedule", (-1, 3))]
    for fn, args in calls:
        with pytest.raises(ValueError) as want:
            getattr(ref_sch, fn)(*args)
        with pytest.raises(ValueError) as got:
            getattr(sch, fn)(*args)
        assert str(got.value) == str(want.value)
    F, B = sch.FWD, sch.BWD
    bad = [((((0, F),), ((0, F),), ((0, B),)), 1, 1),      # fwd twice
           ((((0, B),), ((0, F),)), 1, 1),                   # bwd first
           ((((0, F), None), (None, (0, F)), (None, (0, B)),
             ((0, B), None)), 2, 2),                         # mb 1 missing
           ((((0, F), (0, F)),), 2, 1),                      # same tick
           ((((3, F),),), 1, 1),                             # out of range
           ((((0, "idle"),),), 1, 1)]                        # bad phase
    for ticks, S, M in bad:
        with pytest.raises(ValueError) as want:
            ref_sch.Schedule("x", S, M, ticks).validate()
        with pytest.raises(ValueError) as got:
            sch.Schedule("x", S, M, ticks).validate()
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# heterogeneous balancing and the search
# ---------------------------------------------------------------------------

def _mixes(m):
    """tests/test_heterogeneous.py's mixed clusters, a homogeneous one and
    an H100 pool beside V100s, built from module ``m``'s tables."""
    G = m.DeviceGroup
    h100 = m.Hardware(**{f.name: getattr(cm.H100_SXM, f.name)
                         for f in dataclasses.fields(cm.H100_SXM)})
    return [
        m.ClusterSpec(groups=(G("v100", m.V100_PAPER, 8),
                              G("t4", m.T4_16G, 8))),
        m.ClusterSpec(groups=(G("v100", m.V100_PAPER, 12),
                              G("p100", m.P100_16G, 4))),
        m.ClusterSpec(groups=(G("v100", m.V100_PAPER, 8),
                              G("t4", m.T4_16G, 4),
                              G("p100", m.P100_16G, 4))),
        m.ClusterSpec(groups=(G("tpu", m.TPU_V5E, 8), G("t4", m.T4_16G, 8))),
        m.ClusterSpec.homogeneous(m.V100_PAPER, 16),
        m.ClusterSpec(groups=(G("h100", h100, 8), G("v100", m.V100_PAPER,
                                                     8))),
    ]


MIX_IDS = ["v100+t4", "v100+p100", "v100+t4+p100", "tpu+t4", "homogeneous",
           "h100+v100"]


def test_proportional_split_agrees():
    rng = np.random.default_rng(0)
    cases = [(256, [1.0, 1.0], 0), (256, [3.0, 1.0], 0),
             (22, [56.0, 26.0, 7.5], 1), (7, [1e-9, 1.0], 0),
             (100, [0.0, 0.0], 0), (4, [5.0, 1.0, 1.0, 1.0], 1),
             (3, [1.0, 1.0], 2)]
    for _ in range(200):
        n = int(rng.integers(1, 6))
        cases.append((int(rng.integers(0, 300)),
                      list(rng.uniform(0, 10, n)), int(rng.integers(0, 3))))
    for total, w, minimum in cases:
        assert outcome(hetero.proportional_split, total, w,
                       minimum=minimum) == \
            outcome(ref_het.proportional_split, total, w, minimum=minimum)


@pytest.mark.parametrize("i", range(6), ids=MIX_IDS)
def test_hetero_functions_agree_on_mixed_clusters(i):
    """Every public function of ``hetero`` on tinyllama (batch 256 x 512,
    as tests/test_heterogeneous.py prices it) over every strategy the
    search enumerates for the cluster, balanced and naive."""
    rspec, spec = _mixes(ref_cm)[i], _mixes(cm)[i]
    assert data(spec) == data(rspec)
    assert (spec.n_devices, spec.is_homogeneous, spec.total_flops,
            data(spec.slowest())) == (rspec.n_devices, rspec.is_homogeneous,
                                      rspec.total_flops,
                                      data(rspec.slowest()))
    for axis in ("data", "model", "stage", "pod"):
        assert spec.min_bw(axis) == rspec.min_bw(axis)
    rmeta = _ref_graph("tinyllama-1.1b", 256, 512).workload_meta()
    meta = to_port(rmeta)
    for b in (0, 1, 100, 256):
        assert data(hetero.scale_meta_batch(meta, b)) == \
            data(ref_het.scale_meta_batch(rmeta, b))
    for layers, pp in ((22, 1), (11, 2), (15, 2), (1, 4)):
        assert data(hetero.scale_meta_stage(meta, layers, pp)) == \
            data(ref_het.scale_meta_stage(rmeta, layers, pp))
    rstrats = ref_auto.enumerate_strategies(rmeta, rspec)
    strats = auto.enumerate_strategies(meta, spec)
    assert data(strats) == data(rstrats)
    for rs, s in zip(rstrats, strats):
        assert hetero.strategy_fits_cluster(s, spec) == \
            ref_het.strategy_fits_cluster(rs, rspec)
        for balanced in (True, False):
            assert outcome(hetero.plan_placement, meta, s, spec,
                           overlap=0.5, balanced=balanced) == \
                outcome(ref_het.plan_placement, rmeta, rs, rspec,
                        overlap=0.5, balanced=balanced)
            assert outcome(hetero.hetero_step_cost, meta, s, spec,
                           balanced=balanced) == \
                outcome(ref_het.hetero_step_cost, rmeta, rs, rspec,
                        balanced=balanced)
        if s.pp == 1:
            assert outcome(hetero.balance_batch, meta, s, spec) == \
                outcome(ref_het.balance_batch, rmeta, rs, rspec)
            even = hetero.proportional_split(meta.batch, [
                g.n_devices // s.model_parallel for g in spec.groups])
            assert outcome(hetero.price_batch_shares, meta, s, spec, even,
                           overlap=0.5) == \
                outcome(ref_het.price_batch_shares, rmeta, rs, rspec, even,
                        overlap=0.5)
        else:
            assert outcome(hetero.stage_groups_for, spec, s) == \
                outcome(ref_het.stage_groups_for, rspec, rs)
            assert outcome(hetero.balance_stages, meta, s, spec) == \
                outcome(ref_het.balance_stages, rmeta, rs, rspec)
    names = [g.name for g in spec.groups]
    for removed in ({names[0]: 2}, {names[-1]: spec.groups[-1].n_devices},
                    {"nope": 1}, {names[0]: 99},
                    {n: g.n_devices for n, g in zip(names, spec.groups)}):
        assert outcome(hetero.shrink_cluster, spec, removed) == \
            outcome(ref_het.shrink_cluster, rspec, removed)
    new = (cm.DeviceGroup("t4b", cm.T4_16G, 4),)
    rnew = (ref_cm.DeviceGroup("t4b", ref_cm.T4_16G, 4),)
    for added, ng, rng_ in (({names[0]: 4}, (), ()), ({}, new, rnew),
                            ({"nope": 1}, (), ()), ({names[0]: 0}, (), ()),
                            ({}, new * 2, rnew * 2)):
        assert outcome(hetero.grow_cluster, spec, added, ng) == \
            outcome(ref_het.grow_cluster, rspec, added, rng_)
    for picked in (names[:1], names, [], ["nope"], names[:1] * 2):
        assert outcome(hetero.partition_cluster, spec, picked) == \
            outcome(ref_het.partition_cluster, rspec, picked)


@pytest.mark.parametrize("arch", ("qwen2-vl-2b", "seamless-m4t-medium"))
def test_segment_aware_balancing_agrees(arch):
    """Multi-segment graphs: the segment-respecting stage partitions and
    pipelined placements (a sample of the pipelined strategies on a mixed
    cluster; the whole span DP is slow in pure Python)."""
    rg = _ref_graph(arch)
    g = to_port(rg)
    for pp in range(0, 6):
        for w in ([1.0] * max(pp, 1), list(np.linspace(1.0, 3.0,
                                                       max(pp, 1)))):
            assert hetero.graph_stage_partition(g, pp, w) == \
                ref_het.graph_stage_partition(rg, pp, w)
        assert hetero.partition_min_max(g, pp, lambda s, j, i: (i - j) ** 2
                                        / (s + 1)) == \
            ref_het.partition_min_max(rg, pp, lambda s, j, i: (i - j) ** 2
                                      / (s + 1))
    rspec, spec = _mixes(ref_cm)[0], _mixes(cm)[0]
    rstrats = [s for s in ref_auto.enumerate_strategies(rg, rspec)
               if s.pp > 1][::25]
    for rs in rstrats:
        s = to_port(rs)
        assert outcome(hetero.plan_placement, g, s, spec, overlap=0.5) == \
            outcome(ref_het.plan_placement, rg, rs, rspec, overlap=0.5)
        assert outcome(hetero.balance_stages, g, s, spec) == \
            outcome(ref_het.balance_stages, rg, rs, rspec)


@pytest.mark.parametrize("i", range(6), ids=MIX_IDS)
def test_search_agrees_top5_on_a_cluster_spec(i):
    rspec, spec = _mixes(ref_cm)[i], _mixes(cm)[i]
    rmeta = _ref_graph("tinyllama-1.1b", 256, 512).workload_meta()
    want = ref_auto.search(rmeta, rspec, top_k=5)
    got = auto.search(to_port(rmeta), spec, top_k=5)
    assert len(got) == len(want) > 0
    assert data(got) == data(want)
    assert [c.total for c in got] == [c.total for c in want]
    assert [c.placement.describe() for c in got] == \
        [c.placement.describe() for c in want]
    assert [c.placement.batch_slices() for c in got] == \
        [c.placement.batch_slices() for c in want]


@pytest.mark.parametrize("table", ("TPU_V5E", "V100_PAPER", "H100_SXM"))
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_auto_parallel_agrees(arch, table):
    """The chosen strategy (or the same "no feasible strategy" error) at
    1, 4, 8, 16 and 64 devices; the two multi-segment graphs, whose
    segment-aware search takes seconds a call, at 1 and 4.  The top-5
    frontier at 8 devices agrees too."""
    ref_hw, hw = _tables(table)
    rg = _ref_graph(arch)
    g = to_port(rg)
    counts = (1, 4) if len(rg.segments) > 1 else (1, 4, 8, 16, 64)
    for n in counts:
        assert outcome(auto.auto_parallel, g, n, hw) == \
            outcome(ref_auto.auto_parallel, rg, n, ref_hw)
    if len(rg.segments) == 1:
        assert data(auto.search(g, 8, hw)) == \
            data(ref_auto.search(rg, 8, ref_hw))


@pytest.mark.parametrize("arch", ("qwen2-vl-2b", "seamless-m4t-medium"))
def test_search_over_the_multimodal_graphs_agrees(arch):
    """``auto.search`` over the port's own graph of each multimodal config
    (encdec at a source length apart from the target's) at 4 devices of
    the H100 table: the top-5 frontier with ``==``, and for the vlm the
    driver's search at ``max_pp=1``."""
    ref_hw, hw = _tables("H100_SXM")
    src = 256 if arch == "seamless-m4t-medium" else None
    g = lm.model_graph(get_config(arch), 8, 512, src_seq=src)
    rg = ref_lm.model_graph(jax_get_config(arch), 8, 512, src_seq=src)
    assert data(g) == data(rg)
    got, want = auto.search(g, 4, hw), ref_auto.search(rg, 4, ref_hw)
    assert len(got) == len(want) > 0
    assert data(got) == data(want)
    if arch == "qwen2-vl-2b":
        one = auto.search(g, 4, hw, max_pp=1)
        assert data(one) == data(ref_auto.search(rg, 4, ref_hw, max_pp=1))
        assert all(c.strategy.pp == 1 for c in one)


def test_auto_defaults_to_the_h100_table():
    g = lm.model_graph(get_config("tinyllama-1.1b"), 4, 2048)
    assert auto.auto_parallel(g, 4) == auto.auto_parallel(g, 4, cm.H100_SXM)
    assert data(auto.search(g, 4)) == data(auto.search(g, 4, cm.H100_SXM))


# ---------------------------------------------------------------------------
# the planner's cluster checks
# ---------------------------------------------------------------------------

def test_planner_validates_cluster_specs_and_refuses_mixed_ones():
    model = lm.Model(get_config("tinyllama-1.1b", smoke=True), "cpu")
    homog = cm.ClusterSpec.homogeneous(cm.H100_SXM, 1)
    plan = planner.compile_plan(model, None, cm.StrategySpec(),
                                cluster_spec=homog,
                                workload_meta=model.graph(2, 8)
                                .workload_meta())
    assert plan.strategy == cm.StrategySpec() and plan.mesh is None
    assert plan.placement is None
    # a mixed spec: the reference's balanced placement, priced at overlap
    mixed, ref_mixed = _mixes(cm)[0], _mixes(ref_cm)[0]
    meta = model.graph(16, 8).workload_meta()
    ref_meta = ref_lm.model_graph(jax_get_config("tinyllama-1.1b",
                                                 smoke=True), 16, 8
                                  ).workload_meta()
    for strat in (dict(dp=16), dict(dp=8, pp=2, micro_batches=4)):
        plan = planner.compile_plan(model, None, cm.StrategySpec(**strat),
                                    cluster_spec=mixed, workload_meta=meta,
                                    overlap=0.5)
        assert data(plan.placement) == data(ref_het.plan_placement(
            ref_meta, ref_cm.StrategySpec(**strat), ref_mixed, overlap=0.5))
    # without the workload there is nothing to balance
    assert planner.compile_plan(model, None, cm.StrategySpec(dp=16),
                                cluster_spec=mixed).placement is None
    # a caller's placement passes through, not re-balanced
    placement = hetero.plan_placement(meta, cm.StrategySpec(dp=16), mixed)
    assert planner.compile_plan(model, None, cm.StrategySpec(dp=16),
                                cluster_spec=mixed, workload_meta=meta,
                                placement=placement).placement is placement
    # the reference's tiling check, before any mesh is built
    for strat, spec in ((cm.StrategySpec(dp=4), homog),
                        (cm.StrategySpec(tp=16), mixed),
                        (cm.StrategySpec(dp=8, pp=2), _mixes(cm)[1])):
        with pytest.raises(ValueError, match="does not tile"):
            planner.mesh_for_strategy(strat, device_type="cpu",
                                      cluster_spec=spec)


# ---------------------------------------------------------------------------
# the train driver's --auto
# ---------------------------------------------------------------------------

SMOKE = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
         "--log-every", "1"]


def test_train_driver_auto_chooses_what_the_reference_chooses(tmp_path,
                                                               capsys):
    out = train.main(SMOKE + ["--steps", "1", "--auto", "--hw", "tpu_v5e",
                              "--ckpt-dir", str(tmp_path)])
    want = ref_auto.auto_parallel(
        ref_lm.model_graph(jax_get_config("tinyllama-1.1b", smoke=True), 2,
                           32), 1, ref_cm.TPU_V5E)
    assert out["strategy"] == want.describe() == "single-device"
    assert f"[auto] chose: {want.describe()}\n" in capsys.readouterr().out
    rmeta = ref_lm.model_graph(jax_get_config("tinyllama-1.1b", smoke=True),
                               2, 32).workload_meta()
    assert out["predicted_step_s"] == ref_cm.step_cost(
        rmeta, want, ref_cm.TPU_V5E).total
    # at full width on one TPU v5e the reference picks adafactor (AdamW's
    # state overflows 16 GiB); the driver prints it and keeps --optimizer
    for world in (1, 2, 4):
        for table, hw in (("TPU_V5E", cm.TPU_V5E), ("H100_SXM",
                                                    cm.H100_SXM)):
            rg = _ref_graph("tinyllama-1.1b", 4, 2048)
            want = ref_auto.auto_parallel(rg, world, _tables(table)[0])
            got = train.auto_strategy(
                lm.model_graph(get_config("tinyllama-1.1b"), 4, 2048),
                world, hw)
            assert data(got) == data(want)


def test_train_driver_auto_refuses_strategies_it_cannot_run(tmp_path):
    """The search over 4 devices picks a pipeline for the smoke model at
    batch 4 x 32, which the driver trains; at batch 2 it picks a tensor
    split inside a pipeline (``split×2 pipeline×2(µb=2)``), and over 4
    V100s tinyllama's ``split×2 pipeline×2(µb=4)``: the driver takes both
    as the search picks them, and trains the first under torchrun (the
    V100 pick: tests/test_torch_pipeline_tp.py).  Only a search with no
    feasible strategy exits."""
    g4 = lm.model_graph(get_config("tinyllama-1.1b", smoke=True), 4, 32)
    chosen = auto.auto_parallel(g4, 4)
    assert chosen.pp == 2
    assert train.auto_strategy(g4, 4, cm.H100_SXM) == chosen
    g2 = lm.model_graph(get_config("tinyllama-1.1b", smoke=True), 2, 32)
    assert auto.auto_parallel(g2, 4).describe() == "split×2 pipeline×2(µb=2)"
    full = lm.model_graph(get_config("tinyllama-1.1b"), 4, 2048)
    assert auto.auto_parallel(full, 4, cm.V100_PAPER).describe() == \
        "split×2 pipeline×2(µb=4)"
    for g, hw in ((g2, cm.H100_SXM), (full, cm.V100_PAPER)):
        assert train.auto_strategy(g, 4, hw) == auto.auto_parallel(g, 4, hw)
    with pytest.raises(SystemExit, match="no feasible strategy"):
        train.auto_strategy(
            lm.model_graph(get_config("mamba2-1.3b"), 512, 4096), 1,
            cm.T4_16G)
    # and through torchrun: four gloo ranks train the search's own choice
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--batch", "4", "--seq", "32", "--steps", "2",
         "--log-every", "1", "--auto", "--profile", "--ckpt-dir",
         str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    assert "[auto] chose: replica×2 pipeline×2(µb=2)\n" in p.stdout
    assert "[pipeline] 2 stages, schedule gpipe, µb=2" in p.stdout
    losses = [float(line.split()[3]) for line in p.stdout.splitlines()
              if line.strip().startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    # --profile observes the pipelined step against its priced features
    assert "[profile] h100: 1 step observations" in p.stdout
    assert (tmp_path / "ck" / "step_00000002.COMMITTED").exists()
    # at batch 2 the nested pick trains too
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--batch", "2", "--seq", "32", "--steps", "2",
         "--log-every", "1", "--auto", "--ckpt-dir", str(tmp_path / "ck2")],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    assert "[auto] chose: split×2 pipeline×2(µb=2)\n" in p.stdout
    assert "[pipeline] 2 stages, schedule gpipe, µb=2" in p.stdout
    losses = [float(line.split()[3]) for line in p.stdout.splitlines()
              if line.strip().startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_driver_refuses_auto_with_a_layout_and_elastic_flags(
        tmp_path):
    base = SMOKE + ["--steps", "1", "--ckpt-dir", str(tmp_path)]
    for extra, words in ((["--auto", "--pp", "2"], "drop --mesh and --pp"),
                         (["--auto", "--mesh", "1"], "drop --mesh and --pp"),
                         # the reference's words: a world of one holds no
                         # two hosts
                         (["--hosts", "2"], r"--hosts 2 must divide the "
                                            r"device count \(1\)")):
        with pytest.raises(SystemExit, match=words):
            train.main(base + extra)
    assert not any(tmp_path.iterdir())
    # without --hosts the reference trains and ignores the elastic flags
    for i, extra in enumerate((["--calibrate"], ["--inject-slow", "0:1:2.0"],
                               ["--inject-crash", "1"])):
        out = train.main(SMOKE + ["--steps", "1", "--ckpt-dir",
                                  str(tmp_path / str(i))] + extra)
        assert out["final_step"] == 1 and np.isfinite(out["losses"][0])
