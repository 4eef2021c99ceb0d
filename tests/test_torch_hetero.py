"""The port's heterogeneous placement (``repro_torch.core.planner`` over
``core/hetero.py``) against the reference (``repro``) on the CPU.

Plans are pure Python in both packages and held equal with ``==``: the
placement ``compile_plan`` carries on a mixed ``ClusterSpec`` against the
reference's ``plan_placement``, and ``stage_layers()`` against its
``stage_layers_from_alloc``.  The H100 table has no reference twin: the
reference prices it as data (a reference ``Hardware`` built from its
fields).

Execution runs on gloo ranks (``torch.multiprocessing.spawn`` over a
``FileStore`` in ``tmp_path``): 8 ranks hold the reference's own
acceptance case (tests/test_distributed.py::
test_uneven_hetero_plan_pipeline_matches_reference, which does not run on
this jax) on ``stage 4 × data 2`` with the planned (3, 3, 1, 1) split, and
``dp=8`` with the planned batch shares (7, 1) dealt (2, 2, 2, 1, 1, 0, 0,
0), plain and with a random ``loss_mask``; 4 ranks hold a masked ``dp=4``
step, the masked in-pod weighting under ``compress_pod``, uneven shares
over ``pod × data``, and the errors.  The reference's meshed steps do not
run on this jax, and its SPMD step splits the batch evenly, so each is
held against its unmeshed functions over the whole batch:
``value_and_grad(Model.loss_fn)`` (a token-weighted mean over ranks is the
whole batch's masked mean), its interpreter ``schedule_grads``, and three
steps of its ``adamw``.  The model is the 8-layer smoke tinyllama in f32,
tokens (8, 64) from numpy seed 0; tolerances f32: values 2e-5, gradients
2e-4 (tests/torch_harness.py).
"""
import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.core import cost_model as ref_cm
from repro.core import hetero as ref_het
from repro.models import lm as ref_lm
from repro.optim import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.core import cost_model as cm
from repro_torch.core import planner
from repro_torch.core.cost_model import StrategySpec
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim import grad_compress as gc
from repro_torch.optim.optimizer import adamw
from repro_torch.tree import flatten, tree_map

from torch_harness import TOLS, data

# ``repro.core`` exports the ``pipeline`` scope under the module's name
ref_pipe = importlib.import_module("repro.core.pipeline")
# … and so does ``repro_torch.core``
pipe = importlib.import_module("repro_torch.core.pipeline")

ARCH = "tinyllama-1.1b"
TOL = TOLS["float32"]
LR = 1e-3
B, T, M = 8, 64, 4
STEPS = 3
SMOKE_LAYERS = 8


def _smoke(get):
    return dataclasses.replace(get(ARCH, smoke=True), n_layers=SMOKE_LAYERS)


def _hw(m, name: str):
    """Module ``m``'s table ``name``; the reference builds the H100 table
    from the port's fields."""
    if m is cm or name != "H100_SXM":
        return getattr(m, name)
    return m.Hardware(**{f.name: getattr(cm.H100_SXM, f.name)
                         for f in dataclasses.fields(cm.H100_SXM)})


def _spec(m, *groups):
    """A ClusterSpec of module ``m``: groups as (name, table, count)."""
    return m.ClusterSpec(groups=tuple(m.DeviceGroup(n, _hw(m, hw), c)
                                      for n, hw, c in groups))


V100_P100 = (("v100", "V100_PAPER", 4), ("p100", "P100_16G", 4))
H100_V100 = (("h100", "H100_SXM", 1), ("v100", "V100_PAPER", 1))
PP4 = dict(dp=2, pp=4, micro_batches=M, schedule="1f1b")
PP2 = dict(dp=1, pp=2, micro_batches=4, schedule="1f1b")

#: name: (full width?, n_layers override, planning batch x seq, groups,
#: strategy, want layer_alloc, want batch_shares, want replica rows)
PLANS = {
    "reference_dp2_pp4": (False, None, (64, 512), V100_P100, PP4,
                          (3, 3, 1, 1), (64,), None),
    "tinyllama_pp2": (True, None, (4, 2048), H100_V100, PP2, (19, 3), (4,),
                      None),
    "tinyllama16_dp2": (True, 16, (8, 2048), H100_V100, dict(dp=2), (16,),
                        (7, 1), (7, 1)),
    "tinyllama16_dp2_b4": (True, 16, (4, 2048), H100_V100, dict(dp=2),
                           (16,), (4, 0), (4, 0)),
    "tinyllama_dp2_infeasible": (True, None, (4, 2048), H100_V100,
                                 dict(dp=2), (22,), (2, 2), (2, 2)),
    # the depths around phase 22's 16 layers at its batch of 8: a V100
    # replica fits with AdamW up to 21 layers, (7, 1) up to 20
    "tinyllama20_dp2": (True, 20, (8, 2048), H100_V100, dict(dp=2), (20,),
                        (7, 1), (7, 1)),
    "tinyllama21_dp2": (True, 21, (8, 2048), H100_V100, dict(dp=2), (21,),
                        (8, 0), (8, 0)),
    "tinyllama_dp2_b8_infeasible": (True, None, (8, 2048), H100_V100,
                                    dict(dp=2), (22,), (4, 4), (4, 4)),
    "smoke_dp8": (False, None, (B, T), V100_P100, dict(dp=8),
                  (SMOKE_LAYERS,), (7, 1), (2, 2, 2, 1, 1, 0, 0, 0)),
}


def _cfgs(full: bool, layers):
    if full:
        jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    else:
        jcfg, cfg = _smoke(jax_get_config), _smoke(get_config)
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return jcfg, cfg


@pytest.mark.parametrize("name", PLANS)
def test_plan_matches_reference(name):
    full, layers, (pb, ps), groups, strat, alloc, shares, rows = PLANS[name]
    jcfg, cfg = _cfgs(full, layers)
    plan = planner.compile_plan(
        Model(cfg, "cpu"), None, StrategySpec(**strat),
        cluster_spec=_spec(cm, *groups),
        workload_meta=lm.model_graph(cfg, pb, ps).workload_meta(),
        overlap=0.5)
    want = ref_het.plan_placement(
        ref_lm.model_graph(jcfg, pb, ps).workload_meta(),
        ref_cm.StrategySpec(**strat), _spec(ref_cm, *groups), overlap=0.5)
    assert data(plan.placement) == data(want)
    stack = ref_lm.build(jcfg).stack
    want_sl = (ref_pipe.stage_layers_from_alloc(stack, want.layer_alloc)
               if len(want.layer_alloc) == strat.get("pp", 1) else
               ref_pipe.even_stage_layers(stack.n_rep, strat.get("pp", 1)))
    assert plan.stage_layers() == want_sl
    assert (plan.placement.layer_alloc, plan.placement.batch_shares,
            plan.replica_rows()) == (alloc, shares, rows)
    if strat.get("pp", 1) > 1:
        assert plan.stage_layers() == alloc
    if name == "tinyllama_pp2":
        assert round(plan.placement.cost.total * 1e3, 2) == 216.59
    if name == "tinyllama16_dp2":
        assert plan.placement.batch_slices() == ((0, 7), (7, 8))
        assert round(plan.placement.cost.total * 1e3, 2) == 1007.96
    if name.endswith("infeasible"):
        # a 22-layer replica with AdamW does not fit the V100 table
        assert plan.placement.cost.total == float("inf")


def test_homogeneous_or_absent_spec_leaves_the_plan_as_it_was():
    _, cfg = _cfgs(False, None)
    model = Model(cfg, "cpu")
    meta = lm.model_graph(cfg, B, T).workload_meta()
    strat = StrategySpec(dp=8)
    bare = planner.compile_plan(model, None, strat)
    assert bare.placement is None and bare.replica_rows() is None
    for kw in (dict(cluster_spec=cm.ClusterSpec.homogeneous(cm.V100_PAPER,
                                                            8),
                    workload_meta=meta),
               dict(cluster_spec=_spec(cm, *V100_P100)),
               dict(workload_meta=meta)):
        assert planner.compile_plan(model, None, strat, overlap=0.5,
                                    **kw) == bare
    pipelined = planner.compile_plan(model, None, StrategySpec(pp=4))
    assert pipelined.stage_layers() == (2, 2, 2, 2)


# ---------------------------------------------------------------------------
# the reference, unmeshed, on the whole batch
# ---------------------------------------------------------------------------

def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def ref():
    jcfg = _smoke(jax_get_config)
    jm = ref_lm.build(jcfg)
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    mask = (np.random.default_rng(1).random((B, T)) < 0.7).astype(
        np.float32)
    out = {"params": _np(params), "tokens": tokens, "mask": mask}
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))

    def batch(rows=slice(None), masked=False):
        b = {"tokens": jnp.asarray(tokens[rows])}
        if masked:
            b["loss_mask"] = jnp.asarray(mask[rows])
        return b

    for name, masked in (("plain", False), ("masked", True)):
        (loss, _), g = grad_fn(params, batch(masked=masked))
        out[name] = (float(loss), _np(g))
        # three AdamW steps on the same batch, unmeshed
        opt = jax_opt.adamw(lr=LR)
        p, st, losses = params, opt.init(params), []
        for i in range(STEPS):
            (loss, _), g = grad_fn(p, batch(masked=masked))
            p, st = opt.apply(g, st, p, i)
            losses.append(float(loss))
        out[name, "losses"] = losses
    # each pod's masked mean over its own rows (the in-pod reduction)
    for pod in range(2):
        (loss, _), g = grad_fn(params, batch(slice(4 * pod, 4 * pod + 4),
                                             masked=True))
        out["pod", pod] = (float(loss), _np(g))
    # masked micro-batches of the reference's step: M=2 global halves
    loss_fn = jax.jit(jm.loss_fn)
    out["masked_m2"] = float(np.mean([
        float(loss_fn(params, batch(slice(4 * j, 4 * j + 4), True))[0])
        for j in range(2)]))
    out["rows"] = [(float(l), float(m["tokens"])) for l, m in (
        loss_fn(params, batch(slice(r, r + 1), True)) for r in range(B))]
    loss, g, _ = ref_pipe.schedule_grads(
        jm, params, jnp.asarray(tokens), micro_batches=M, schedule="1f1b",
        stage_layers=(3, 3, 1, 1))
    out["interp"] = (float(loss), _np(g))
    return out


# ---------------------------------------------------------------------------
# the port on gloo ranks
# ---------------------------------------------------------------------------

def _fresh(params: dict) -> dict:
    """A copy of ``params`` (the optimizer updates its tree in place)."""
    return tree_map(torch.clone, params)


def _spy(opt, seen: dict):
    """``opt`` whose ``apply`` keeps the first gradient it is handed."""
    real_apply = opt.apply

    def apply(grads, state, p, step, **kw):
        if step == 0:
            seen["grads"] = {k: v.clone() for k, v in zip(*flatten(grads))}
        return real_apply(grads, state, p, step, **kw)

    return dataclasses.replace(opt, apply=apply)


def _dp_case(plan, params, batch, res, meta, name, **kw):
    """Three steps of ``plan.train_step_fn`` on this rank's slice."""
    seen = {}
    opt = _spy(adamw(lr=LR), seen)
    step = plan.train_step_fn(opt, **kw)
    mine = plan.batch_slice(batch)
    params = _fresh(params)
    state = opt.init(params)
    losses, tokens = [], []
    for i in range(STEPS):
        params, state, m = step(params, state, mine, i)
        losses.append(float(m["loss"]))
        tokens.append(float(m["tokens"]))
    meta[name] = {"rows": mine["tokens"].shape[0], "losses": losses,
                  "tokens": tokens, "replica_rows": plan.replica_rows()}
    for path, v in seen["grads"].items():
        res[f"{name}/grads/{path}"] = v.numpy()


def _rank8(rank, cfg, params, batch, spec8, res, meta):
    model = Model(cfg, "cpu")
    # the reference's acceptance case: stage 4 x data 2, planned layers
    strat = StrategySpec(**PP4)
    mesh = planner.mesh_for_strategy(strat, device_type="cpu",
                                     cluster_spec=spec8)
    plan = planner.compile_plan(
        model, mesh, strat, cluster_spec=spec8,
        workload_meta=lm.model_graph(cfg, 64, 512).workload_meta(),
        overlap=0.5)
    sl = plan.stage_layers()
    stage = mesh.get_local_rank("stage")
    seen = {}
    opt = _spy(adamw(lr=LR), seen)
    step = plan.pipeline_train_step_fn(opt)
    local = pipe.stage_state(_fresh(params), stage, sl)
    state = opt.init(local)
    toks = plan.batch_slice(batch)["tokens"]
    losses = []
    for i in range(STEPS):
        local, state, m = step(local, state, toks, i)
        losses.append(float(m["loss"]))
    meta["pp4"] = {"stage": stage, "data": mesh.get_local_rank("data"),
                   "stage_layers": list(sl), "losses": losses,
                   "rows": toks.shape[0]}
    for path, v in seen["grads"].items():
        res[f"pp4/grads/{path}"] = v.numpy()
    # dp=8 with the planned batch shares, plain and masked
    strat = StrategySpec(dp=8)
    mesh = planner.mesh_for_strategy(strat, device_type="cpu",
                                     cluster_spec=spec8)
    plan = planner.compile_plan(
        model, mesh, strat, cluster_spec=spec8,
        workload_meta=lm.model_graph(cfg, B, T).workload_meta(), overlap=0.5)
    meta["dp8_shares"] = list(plan.placement.batch_shares)
    _dp_case(plan, params, {"tokens": batch["tokens"]}, res, meta, "dp8")
    _dp_case(plan, params, batch, res, meta, "dp8_masked")


def _rank4(rank, cfg, params, batch, spec4, res, meta):
    model = Model(cfg, "cpu")
    # a masked dp=4 step: the token-weighted mean over data
    plan = planner.compile_plan(model, port_mesh.parse_mesh(
        "4", device_type="cpu"))
    _dp_case(plan, params, batch, res, meta, "dp4_masked")
    o = adamw(lr=LR)
    p = _fresh(params)
    meta["dp4_masked_m2"] = float(plan.train_step_fn(o, micro_batches=2)(
        p, o.init(p), plan.batch_slice(batch), 0)[2]["loss"])
    # pod 2 x data 2, compressed: weighted inside the pod only
    pods = port_mesh.parse_mesh("2x2x1", device_type="cpu")
    plan = planner.compile_plan(model, pods)
    seen = {}
    real_tree = gc.compressed_psum_tree

    def spy_tree(grads, group, err, **kw):
        seen["inpod"] = {k: v.clone() for k, v in zip(*flatten(grads))}
        return real_tree(grads, group, err, **kw)

    gc.compressed_psum_tree = spy_tree
    try:
        step = plan.train_step_fn(adamw(lr=LR), compress_pod=True)
        p = _fresh(params)
        _, _, m, _ = step(p, adamw(lr=LR).init(p), plan.batch_slice(batch),
                          0, gc.init_error_tree(p))
    finally:
        gc.compressed_psum_tree = real_tree
    meta["pod_masked"] = {"pod": pods.get_local_rank("pod"),
                          "loss": float(m["loss"])}
    for path, v in seen["inpod"].items():
        res[f"pod_masked/inpod/{path}"] = v.numpy()
    # uneven shares over pod x data (weighted over data, then pod)
    strat = StrategySpec(dp=4)
    uneven = planner.compile_plan(
        model, pods, strat, cluster_spec=spec4,
        workload_meta=lm.model_graph(cfg, B, T).workload_meta(), overlap=0.5)
    _dp_case(uneven, params, {"tokens": batch["tokens"]}, res, meta,
             "pod_uneven")
    # the errors
    try:
        uneven.train_step_fn(adamw(lr=LR), compress_pod=True)
    except ValueError as e:
        meta["compress_refused"] = str(e)
    try:
        uneven.batch_slice({"tokens": batch["tokens"][:6]})
    except ValueError as e:
        meta["shares_refused"] = str(e)


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    d = dict(np.load(inputs))
    cfg = _smoke(get_config)
    params = params_from_numpy(
        cfg, {k[len("p/"):]: v for k, v in d.items() if k.startswith("p/")},
        "cpu")
    batch = {"tokens": torch.tensor(d["tokens"]),
             "loss_mask": torch.tensor(d["mask"])}
    res, meta = {}, {}
    if world == 8:
        _rank8(rank, cfg, params, batch, _spec(cm, *V100_P100), res, meta)
    else:
        _rank4(rank, cfg, params, batch, _spec(
            cm, ("v100", "V100_PAPER", 2), ("p100", "P100_16G", 2)), res,
            meta)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _spawn(world: int, ref, tmp_path_factory) -> list:
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp(f"hetero{world}")
    np.savez(d / "inputs.npz", tokens=ref["tokens"], mask=ref["mask"],
             **{f"p/{k}": v for k, v in ref["params"].items()})
    ctx = mp.start_processes(
        _rank_main, args=(world, str(d / "store"), str(d / "inputs.npz"),
                          str(d)), nprocs=world, join=False,
        start_method="spawn")
    for p in ctx.processes:
        p.join(240)
    alive = [p for p in ctx.processes if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank did not finish within 240 s"
    assert ctx.join(), "the ranks did not exit"
    out = []
    for r in range(world):
        with open(d / f"rank{r}.json") as f:
            out.append((dict(np.load(d / f"rank{r}.npz")), json.load(f)))
    return out


@pytest.fixture(scope="module")
def ranks8(ref, tmp_path_factory):
    return _spawn(8, ref, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(ref, tmp_path_factory):
    return _spawn(4, ref, tmp_path_factory)


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=tol, rtol=tol,
                                   err_msg=f"{what} {path}")


def _tree(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def test_planned_pipeline_matches_reference(ranks8, ref):
    """(3, 3, 1, 1) over stage 4 x data 2: the step-0 loss against the
    reference's interpreter and unpipelined loss, each replica's gradients
    (its stages' rows) against both, and three AdamW steps against the
    reference's unmeshed loop, reducing the loss."""
    for _, meta in ranks8:
        m = meta["pp4"]
        assert m["stage_layers"] == [3, 3, 1, 1] and m["rows"] == 4
        for want in (ref["interp"][0], ref["plain"][0]):
            np.testing.assert_allclose(m["losses"][0], want, atol=TOL.fwd,
                                       rtol=TOL.fwd)
        np.testing.assert_allclose(m["losses"], ref["plain", "losses"],
                                   atol=TOL.fwd, rtol=TOL.fwd)
        assert m["losses"][-1] < m["losses"][0]
    for d in range(2):
        mine = sorted(((meta["pp4"]["stage"], got) for got, meta in ranks8
                       if meta["pp4"]["data"] == d), key=lambda x: x[0])
        assert [s for s, _ in mine] == [0, 1, 2, 3]
        grads = {}
        for path in _tree(mine[0][1], "pp4/grads/"):
            key = f"pp4/grads/{path}"
            grads[path] = (np.concatenate([got[key] for _, got in mine])
                           if path.startswith("blocks/") else mine[0][1][key])
        for want in (ref["interp"][1], ref["plain"][1]):
            _close(grads, want, TOL.grad, f"replica {d}")


@pytest.mark.parametrize("name,want", [("dp8", "plain"),
                                       ("dp8_masked", "masked")])
def test_uneven_batch_shares_match_reference(name, want, ranks8, ref):
    """dp=8 with the planned shares (7, 1): rows (2, 2, 2, 1, 1, 0, 0, 0),
    three ranks with none; every rank hands the optimizer the whole
    batch's gradient, and three steps follow the reference's loop."""
    tokens = [meta[name]["tokens"][0] for _, meta in ranks8]
    assert len(set(tokens)) == 1
    for rank, (got, meta) in enumerate(ranks8):
        m = meta[name]
        assert meta["dp8_shares"] == [7, 1]
        assert m["replica_rows"] == [2, 2, 2, 1, 1, 0, 0, 0]
        assert m["rows"] == m["replica_rows"][rank]
        np.testing.assert_allclose(m["losses"], ref[want, "losses"],
                                   atol=TOL.fwd, rtol=TOL.fwd)
        np.testing.assert_allclose(m["losses"][0], ref[want][0],
                                   atol=TOL.fwd, rtol=TOL.fwd)
        _close(_tree(got, f"{name}/grads/"), ref[want][1], TOL.grad,
               f"{name} rank {rank}")
    n = (B * (T - 1) if want == "plain" else ref["mask"][:, 1:].sum())
    assert tokens[0] == n


def test_masked_and_pod_steps_match_reference(ranks4, ref):
    """A masked dp=4 step (the weighted mean over data), the masked in-pod
    weighting under compress_pod, and uneven shares (4, 3, 1, 0) over pod
    2 x data 2 (weighted over data, then pod)."""
    for rank, (got, meta) in enumerate(ranks4):
        m = meta["dp4_masked"]
        np.testing.assert_allclose(m["losses"], ref["masked", "losses"],
                                   atol=TOL.fwd, rtol=TOL.fwd)
        _close(_tree(got, "dp4_masked/grads/"), ref["masked"][1], TOL.grad,
               f"dp4_masked rank {rank}")
        pod = meta["pod_masked"]["pod"]
        _close(_tree(got, "pod_masked/inpod/"), ref["pod", pod][1],
               TOL.grad, f"pod {pod} in-pod gradient")
        # the metrics: the reference's pmean over pods of each pod's mean
        np.testing.assert_allclose(
            meta["pod_masked"]["loss"],
            (ref["pod", 0][0] + ref["pod", 1][0]) / 2, atol=TOL.fwd,
            rtol=TOL.fwd)
        u = meta["pod_uneven"]
        assert u["replica_rows"] == [4, 3, 1, 0]
        assert u["rows"] == u["replica_rows"][rank]
        np.testing.assert_allclose(u["losses"], ref["plain", "losses"],
                                   atol=TOL.fwd, rtol=TOL.fwd)
        _close(_tree(got, "pod_uneven/grads/"), ref["plain"][1], TOL.grad,
               f"pod_uneven rank {rank}")


def test_masked_micro_batches_weight_each_rank_by_its_mean_count(ranks4,
                                                                 ref):
    """With a loss_mask and M > 1 the port deals rows, then micro-batches
    them: each rank's loss is the mean of its micro-batches' masked means,
    weighted by its mean token count.  The reference micro-batches the
    global batch (GSPMD splits each micro-batch over ``data``), so its
    mean of two global halves' masked means is another number: a caveat
    of the reference's semantics (ROADMAP §C), not a tolerance."""
    rows = ref["rows"]              # (masked mean, tokens) of each row
    n = [(rows[2 * i][1] + rows[2 * i + 1][1]) / 2 for i in range(4)]
    loss = [(rows[2 * i][0] + rows[2 * i + 1][0]) / 2 for i in range(4)]
    want = sum(a * b for a, b in zip(n, loss)) / sum(n)
    for _, meta in ranks4:
        got = meta["dp4_masked_m2"]
        np.testing.assert_allclose(got, want, atol=TOL.fwd, rtol=TOL.fwd)
        assert abs(got - ref["masked_m2"]) > TOL.fwd * (1 + abs(got))


def test_uneven_shares_refuse_compression_and_a_wrong_batch(ranks4):
    for _, meta in ranks4:
        assert "compress_pod" in meta["compress_refused"]
        assert "(4, 3, 1, 0)" in meta["compress_refused"]
        assert "sum to 8, the global batch is 6" in meta["shares_refused"]
