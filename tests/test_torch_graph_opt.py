"""The port's graph optimizer (``repro_torch.core.graph_opt``) and the
strategies it derives, held with ``==`` against the reference's
(``repro.core.graph_opt``): nesting rules and their messages, bridges and
their prices, gradient-aggregation placement, replication degrees,
``LoweredGraph.describe()``, ``strategy_from_taskgraph`` for the paper's
Cases 1–5, the hardware tags of stage virtual devices and
``compile_nested_plan``'s placement on mixed clusters.

The same annotated program is recorded by both packages' scopes.  The
reference records on its one CPU device (a mesh of ``Auto`` axes, whose
sharding constraints jax 0.9 accepts outside ``jit``) and is then lowered
over a ``jax.sharding.AbstractMesh`` of the port's shape: its ``lower``
reads only ``mesh.shape``.  The port records over a stand-in mesh of that
shape (the names and sizes a ``DeviceMesh`` gives ``mesh_shape``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

import repro as rwh
import repro_torch as wh
from repro.configs import get_config as jax_get_config
from repro.core import cost_model as ref_cm
from repro.core import graph_opt as ref_go
from repro.core import ir as ref_ir
from repro.models import lm as ref_lm
from repro_torch.configs import get_config
from repro_torch.core import cost_model as cm
from repro_torch.core import graph_opt as go
from repro_torch.core import ir
from repro_torch.core import planner
from repro_torch.models import lm
from repro_torch.models.lm import Model

from torch_harness import data, outcome


class StandInMesh:
    """What the annotation API reads of a ``DeviceMesh``: its dim names
    and its grid of ranks (sizes), without a process group."""

    def __init__(self, shape: tuple, names: tuple):
        self.mesh_dim_names = tuple(names)
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)


def _hw(m, name: str):
    """Module ``m``'s table ``name``; the reference builds the H100 table
    from the port's fields."""
    if m is cm or name != "H100_SXM":
        return getattr(m, name)
    return m.Hardware(**{f.name: getattr(cm.H100_SXM, f.name)
                         for f in dataclasses.fields(cm.H100_SXM)})


def _spec(m, *groups):
    return m.ClusterSpec(groups=tuple(m.DeviceGroup(n, _hw(m, hw), c)
                                      for n, hw, c in groups))


def _dtype(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


def _metas(ts) -> list:
    return [(tuple(t.shape), _dtype(t.dtype)) for t in ts]


def node(n) -> dict:
    """A recorded Subgraph as plain data, dtypes by name."""
    return {"name": n.name, "strategy": [(a.kind, a.options, a.depth)
                                         for a in n.strategy],
            "inputs": _metas(n.inputs), "outputs": _metas(n.outputs),
            "params": _metas(n.params), "flops": n.flops,
            "vdevice": data(n.vdevice), "depth": n.nesting_depth,
            "param_bytes": n.param_bytes,
            "activation_bytes": n.activation_bytes}


# ---------------------------------------------------------------------------
# the annotated programs (tests/test_graph_opt.py, tests/test_core.py and
# the paper's Cases), each written once for both packages
# ---------------------------------------------------------------------------

def _net(p, x):
    return x @ p["w"]


def _p(arr, n=8, m=8):
    return {"w": arr(np.ones((n, m), np.float32))}


def _x(arr, *shape):
    return arr(np.ones(shape, np.float32))


def replica_split(W, arr):
    with W.replica():
        with W.split(dim=-1):
            W.sub("fc", _net)(_p(arr), _x(arr, 4, 8))


def expert_split(W, arr):
    with W.replica():
        with W.split(experts=True):
            W.sub("moe", _net)(_p(arr), _x(arr, 4, 8))


def m6_nest(W, arr):
    with W.replica():
        h = W.sub("attn", _net)(_p(arr), _x(arr, 4, 8))
        with W.split(experts=True):
            h = W.sub("moe", _net)(_p(arr), h)
        W.sub("out", _net)(_p(arr), h)


def case1_2(W, arr):
    with W.replica():
        h = W.sub("backbone", _net)(_p(arr, 4, 8), _x(arr, 2, 4))
    with W.split(dim=-1):
        W.sub("fc", _net)(_p(arr, 8, 16), h)


def case3_4(W, arr):
    with W.replica():
        with W.pipeline(micro_batch=6):
            with W.stage():
                W.sub("s0", lambda x: x * 1.0)(_x(arr, 3))
            with W.stage():
                W.sub("s1", lambda x: x * 2.0)(_x(arr, 3))


def case4_nested(W, arr):
    with W.pipeline(micro_batch=4):
        for i in range(2):
            with W.stage():
                with W.replica():
                    with W.split(dim=-1):
                        W.sub(f"s{i}", _net)(_p(arr), _x(arr, 4, 8))


def case5(W, arr):
    with W.auto_scope():
        with W.replica():
            W.sub("net", _net)(_p(arr), _x(arr, 4, 8))


def entry_exit(W, arr):
    with W.replica():
        h = W.sub("pre", _net)(_p(arr), _x(arr, 4, 8))
    with W.pipeline(micro_batch=2):
        with W.stage():
            h = W.sub("a", _net)(_p(arr), h)
        with W.stage():
            h = W.sub("b", _net)(_p(arr), h)
    with W.replica():
        W.sub("post", _net)(_p(arr, 8, 16), h)


#: name: (program, axis names, the port's mesh shape, the strategy it
#: derives there)
PROGRAMS = {
    "replica_split": (replica_split, ("data", "model"), (2, 2),
                      dict(dp=2, tp=2)),
    "expert_split": (expert_split, ("data", "model"), (2, 4),
                     dict(dp=2, ep=4, vocab_split=False)),
    "m6_nest": (m6_nest, ("data", "model"), (4, 2),
                dict(dp=4, ep=2, vocab_split=False)),
    "case1_2": (case1_2, ("data", "model"), (2, 2), dict(dp=2, tp=2)),
    "case3_4": (case3_4, ("stage", "data", "model"), (2, 2, 1),
                dict(dp=2, pp=2, micro_batches=6, vocab_split=False)),
    "case4_nested": (case4_nested, ("stage", "data", "model"), (2, 1, 2),
                     dict(tp=2, pp=2, micro_batches=4)),
    "case5": (case5, ("data",), (4,), dict(dp=4, vocab_split=False)),
    "entry_exit": (entry_exit, ("pod", "stage", "data", "model"),
                   (2, 2, 2, 1), dict(dp=4, pp=2, micro_batches=2,
                                      vocab_split=False)),
}


def record_both(name: str) -> tuple:
    """(the reference's cluster, lowered over an AbstractMesh of the
    port's shape, and the port's cluster) after recording ``name``."""
    prog, names, shape, _ = PROGRAMS[name]
    mesh = jax.make_mesh((1,) * len(names), names,
                         axis_types=(AxisType.Auto,) * len(names))
    with rwh.cluster(mesh=mesh) as rcl:
        prog(rwh, jnp.asarray)
    rcl.mesh = AbstractMesh(shape, names)
    with wh.cluster(mesh=StandInMesh(shape, names)) as cl:
        prog(wh, torch.from_numpy)
    return rcl, cl


@pytest.mark.parametrize("name", PROGRAMS)
def test_recorded_graph_matches_reference(name):
    rcl, cl = record_both(name)
    assert [node(n) for n in cl.taskgraph.nodes] == \
        [node(n) for n in rcl.taskgraph.nodes]


@pytest.mark.parametrize("name", PROGRAMS)
def test_lowered_graph_matches_reference(name):
    """Bridges, gradient aggregations, replication degrees, depth, the
    derived strategy and ``describe()``, with ``==``."""
    rcl, cl = record_both(name)
    want, got = ref_go.lower(rcl), go.lower(cl)
    assert data(got.strategy) == data(want.strategy)
    assert got.strategy == cm.StrategySpec(**PROGRAMS[name][3])
    assert data(got.edges) == data(want.edges)
    assert data(got.grad_aggs) == data(want.grad_aggs)
    assert got.replication == want.replication
    assert got.max_nesting_depth == want.max_nesting_depth
    assert got.describe() == want.describe()
    assert data(wh.strategy_from_taskgraph(cl)) == \
        data(rwh.strategy_from_taskgraph(rcl))


@pytest.mark.parametrize("table", ["V100_PAPER", "H100_SXM", "P100_16G"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_bridge_costs_match_reference(name, table):
    rcl, cl = record_both(name)
    want, got = ref_go.lower(rcl), go.lower(cl)
    for e, re_ in zip(got.edges, want.edges):
        for n in (1, 2, 8):
            assert go.bridge_cost(e.bridge, _hw(cm, table), n) == \
                ref_go.bridge_cost(re_.bridge, _hw(ref_cm, table), n)


def test_case_graphs_bridge_as_the_paper_nests():
    """What each Case lowers to (on the port's own, already held equal)."""
    kinds = {name: [e.bridge.kind for e in go.lower(record_both(name)[1])
                    .edges] for name in PROGRAMS}
    assert kinds["m6_nest"] == ["all_to_all", "all_to_all"]
    assert kinds["case1_2"] == ["all_gather"]
    assert kinds["case4_nested"] == ["p2p"]
    assert kinds["entry_exit"] == ["p2p", "p2p", "p2p"]


# ---------------------------------------------------------------------------
# nesting legality: the same kinds, depths and messages
# ---------------------------------------------------------------------------

STACKS = [
    ((), None, True), (("replica", "split"), None, True),
    (("pipeline", "stage", "replica", "split"), None, True),
    (("replica", "pipeline", "stage"), None, True),
    (("pipeline", "split", "replica"), None, True),
    (("replica", "replica"), None, True),
    (("stage",), None, True), (("stage", "pipeline"), None, True),
    (("auto", "replica", "auto", "split"), None, True),
    ((), "split", False), ((), "auto", False), (("split",), "replica", True),
    (("replica",), "replica", True), ((), "stage", True),
    (("pipeline",), "stage", True), (("pipeline", "stage"), "pipeline", True),
    (("replica",), "split", True),
]


@pytest.mark.parametrize("kinds,entering,in_cluster", STACKS)
def test_validate_nesting_matches_reference(kinds, entering, in_cluster):
    kw = dict(entering=entering, in_cluster=in_cluster)
    assert outcome(go.validate_nesting, kinds, **kw) == \
        outcome(ref_go.validate_nesting, kinds, **kw)


def _scope_error(W, nest: tuple, cluster: bool):
    """The error (type name, message) entering scopes ``nest`` raises."""
    def enter():
        import contextlib
        with contextlib.ExitStack() as st:
            for kind in nest:
                st.enter_context(getattr(W, kind)())
    if not cluster:
        return outcome(enter)
    names = ("data",)
    if W is rwh:
        mesh = jax.make_mesh((1,), names, axis_types=(AxisType.Auto,))
    else:
        mesh = StandInMesh((1,), names)
    with W.cluster(mesh=mesh):
        return outcome(enter)


@pytest.mark.parametrize("nest,cluster", [
    (("split",), False), (("split", "replica"), True),
    (("replica", "replica"), True), (("stage",), True),
    (("replica", "split"), True), (("pipeline", "stage", "replica"), True),
])
def test_scope_entry_errors_match_reference(nest, cluster):
    got = _scope_error(wh, nest, cluster)
    assert got == _scope_error(rwh, nest, cluster)
    if nest == ("split",):
        assert "outside any wh.cluster" in got[2]


def test_nested_scopes_record_depths_and_vdevices():
    rcl, cl = record_both("expert_split")
    sg = cl.taskgraph.by_name("moe")
    assert sg.split_options()["experts"] is True
    assert sg.vdevice.name == "hybrid" and sg.nesting_depth == 2
    assert [a.depth for a in sg.strategy] == [0, 1]


# ---------------------------------------------------------------------------
# hand-built graphs: bridges, insertion and aggregation
# ---------------------------------------------------------------------------

def _sg(m, dtype, name, kinds, *, experts=False, stage=None,
        out_shape=(4, 8)):
    anns = []
    for k in kinds:
        opts = {}
        if k == "split":
            opts = {"dim": -1, "experts": experts}
        if k == "stage":
            opts = {"index": stage}
        anns.append(m.StrategyAnnotation(k, opts))
    return m.Subgraph(name=name, fn=None, strategy=anns,
                      outputs=[m.TensorMeta(out_shape, dtype)],
                      params=[m.TensorMeta((8, 8), dtype)])


def _both(*args, **kw):
    return (_sg(ir, torch.float32, *args, **kw),
            _sg(ref_ir, jnp.float32, *args, **kw))


PAIRS = {
    "replica_to_split": (("a", ("replica",)), ("b", ("replica", "split"))),
    "split_to_replica": (("a", ("replica", "split")), ("b", ("replica",))),
    "dispatch": (("attn", ("replica",)),
                 ("moe", ("replica", "split"), True)),
    "combine": (("moe", ("replica", "split"), True),
                ("attn", ("replica",))),
    "stages": (("s0", ("pipeline", "stage"), False, 0),
               ("s1", ("pipeline", "stage"), False, 1)),
    "pipeline_exit": (("s0", ("pipeline", "stage"), False, 0),
                      ("loss", ("replica",))),
    "pipeline_entry": (("loss", ("replica",)),
                       ("s0", ("pipeline", "stage"), False, 0)),
    "identity": (("a", ("replica",)), ("b", ("replica",))),
}


def _pair(spec):
    name, kinds, *rest = spec
    experts = rest[0] if rest else False
    stage = rest[1] if len(rest) > 1 else None
    return _both(name, kinds, experts=experts, stage=stage)


@pytest.mark.parametrize("pair", PAIRS)
def test_plan_bridge_matches_reference(pair):
    (src, rsrc), (dst, rdst) = (_pair(s) for s in PAIRS[pair])
    got, want = go.plan_bridge(src, dst), ref_go.plan_bridge(rsrc, rdst)
    assert data(got) == data(want)
    for table in ("V100_PAPER", "H100_SXM"):
        assert go.bridge_cost(got, _hw(cm, table), 8) == \
            ref_go.bridge_cost(want, _hw(ref_cm, table), 8)


def test_insert_bridges_and_grad_aggregation_match_reference():
    specs = [("attn", ("replica",)), ("moe", ("replica", "split"), True),
             ("out", ("replica",)), ("head", ("split",)),
             ("tp", ("replica", "split"))]
    tg, rtg = ir.TaskGraph(), ref_ir.TaskGraph()
    for s in specs:
        a, b = _pair(s)
        tg.add(a)
        rtg.add(b)
    assert data(go.insert_bridges(tg)) == data(ref_go.insert_bridges(rtg))
    go.insert_bridges(tg)                  # idempotent, as the reference's
    assert len(tg.edges) == len(specs) - 1
    assert tg.edges_into("moe")[0].src == "attn"
    for ep, tp in ((1, 1), (4, 1), (1, 2), (2, 2)):
        assert data(go.place_grad_aggregation(tg, ep=ep, tp=tp)) == \
            data(ref_go.place_grad_aggregation(rtg, ep=ep, tp=tp))


def test_replication_degree_matches_reference():
    for kinds in (("replica",), ("split",), ("replica", "split"), ()):
        a, b = _both("x", kinds)
        for axes in ({"data": 4}, {"pod": 2, "data": 2, "model": 2},
                     {"model": 8}):
            assert go.replication_degree(a, axes) == \
                ref_go.replication_degree(b, axes)


# ---------------------------------------------------------------------------
# the engine: nested plans, expert splits, mixed clusters
# ---------------------------------------------------------------------------

def test_expert_split_lowers_and_prices_but_does_not_compile():
    """ep > 1 lowers and prices as the reference does, and (since the MoE
    family is ported) compiles: the M6 nesting's plan over the deepseek
    smoke model splits whole experts over ``model`` and keeps the vocab
    whole.  Its step on gloo ranks is tests/test_torch_moe.py's."""
    rcl, cl = record_both("m6_nest")
    low = go.lower(cl)
    assert low.strategy.ep == 2
    meta = ref_lm.model_graph(dataclasses.replace(
        jax_get_config("deepseek-moe-16b"), n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=4, head_dim=64, d_ff=1024, n_experts=8,
        top_k=2, d_ff_expert=256, n_shared=0, moe_every=2, vocab=1000,
        name="moe-test"), 64, 128).workload_meta()
    port_meta = cm.WorkloadMeta(**dataclasses.asdict(meta))
    for table in ("V100_PAPER", "H100_SXM"):
        got = cm.step_cost(port_meta, low.strategy, _hw(cm, table),
                           overlap=0.5)
        want = ref_cm.step_cost(meta, ref_go.lower(rcl).strategy,
                                _hw(ref_cm, table), overlap=0.5)
        assert data(got) == data(want)
        assert got.detail["ep_all_to_all"] > 0
    plan = go.compile_nested_plan(cl, Model(get_config(
        "deepseek-moe-16b", smoke=True), "cpu"))
    assert plan.strategy == low.strategy
    assert (plan.strategy.dp, plan.strategy.ep, plan.strategy.tp,
            plan.strategy.vocab_split) == (4, 2, 1, False)
    moe = plan.param_specs["blocks"]["p0"]["moe"]
    assert moe["w_in"] == moe["w_gate"] == moe["w_out"] == (None, "model",
                                                            None, None)
    assert moe["router"]["w"] == (None, None, None)
    assert plan.param_specs["head"]["w"] == (None, None)
    assert not hasattr(planner, "EXPERT_SLICE")


HETERO = {
    "v100_p100": ((("v100", "V100_PAPER", 4), ("p100", "P100_16G", 4)),
                  (2, 4, 1), 8, (64, 512)),
    "h100_v100": ((("h100", "H100_SXM", 1), ("v100", "V100_PAPER", 1)),
                  (2, 1, 1), 8, (4, 2048)),
}


def _two_stages(W, arr):
    with W.pipeline(micro_batch=4):
        for i in range(2):
            with W.stage():
                W.sub(f"stage{i}", _net)(_p(arr), _x(arr, 4, 8))


@pytest.mark.parametrize("name", HETERO)
def test_hardware_tags_and_nested_placement_match_reference(name):
    """On a mixed ClusterSpec each stage's virtual device names the
    hardware the planner deals it, and ``compile_nested_plan`` carries
    the reference's balanced placement."""
    groups, shape, layers, (pb, ps) = HETERO[name]
    names = ("stage", "data", "model")
    # a pure stage nest applies no sharding constraint in the reference,
    # so it records over the AbstractMesh itself
    with rwh.cluster(mesh=AbstractMesh(shape, names),
                     spec=_spec(ref_cm, *groups)) as rcl:
        _two_stages(rwh, jnp.asarray)
    with wh.cluster(mesh=StandInMesh(shape, names),
                    spec=_spec(cm, *groups)) as cl:
        _two_stages(wh, torch.from_numpy)
    got = [data(n.vdevice) for n in cl.taskgraph.nodes]
    assert got == [data(n.vdevice) for n in rcl.taskgraph.nodes]
    assert [v["hardware"] for v in got] == \
        [_hw(cm, g[1]).name for g in groups]
    for i in range(2):
        for n in (None, 2, 4):
            assert data(cl.stage_vd(i, n)) == data(rcl.stage_vd(i, n))
    jcfg = dataclasses.replace(jax_get_config("tinyllama-1.1b"),
                               n_layers=layers)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=layers)
    plan = go.compile_nested_plan(
        cl, Model(cfg, "cpu"), overlap=0.5,
        workload_meta=lm.model_graph(cfg, pb, ps).workload_meta())
    want = ref_go.compile_nested_plan(
        rcl, ref_lm.build(jcfg), overlap=0.5,
        workload_meta=ref_lm.model_graph(jcfg, pb, ps).workload_meta())
    assert plan.placement is not None
    assert data(plan.placement) == data(want.placement)
    assert data(plan.strategy) == data(want.strategy)
    assert plan.stage_layers() == plan.placement.layer_alloc
