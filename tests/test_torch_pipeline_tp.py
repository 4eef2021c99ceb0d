"""Whale's nested hybrid in the port (paper Case 4: ``split`` inside
pipeline ``stage``s under ``replica``): ``compile_plan`` with ``pp > 1``
beside a ``model`` axis, and ``data`` and ``pod`` replicas, through
``pipeline_train_step_fn``, against the reference (``repro``) on the CPU.

The reference's pipelined executor does not run on this jax
(tests/test_distributed.py::test_gpipe_loss_matches_reference), so each
case is held against its unmeshed pieces on the same weights (carried
across by ``models/convert.py``) and the same seeded numpy batch: its
``loss_fn`` under ``jax.value_and_grad`` on the whole batch and its AdamW
loop, and its interpreter ``schedule_grads`` for two cases.  The smoke
tinyllama in f32 with the vocab cut to 500 (padded to 512, so the last
vocab shard holds padding columns) and remat ``full``: with its one kv
head the attention is ``repeat`` at tp 2, with ``n_kv_heads=2``
``grouped``.  Tolerances f32 (tests/torch_harness.py): the step-0 loss
and three AdamW steps' losses within 2e-5, every gathered step-0 gradient
leaf within 2e-4.

One spawn of 4 gloo ranks (``stage 2 × model 2``): gpipe and 1f1b at µb 2
and 4, the grouped layout, tied embeddings, uneven stages (2, 1) at 3
layers, and the backward on a thread of its own (as the autograd engine
runs it on the card); the pipelined start from ``init_pipeline_params``
against a slice of the unpipelined one; the checkpoint, gathered in
``pipeline_params``' padded layout, restored into the ranks' blocks and
into the unpipelined ``replica×2{split×2}`` plan, whose next step is the
reference's.  One spawn of 8 (``pod 2 × stage 2 × model 2`` and ``stage
2 × data 2 × model 2``, with ZeRO 0, 1 and 3, which lay nothing over data
inside a pipeline and so equal ZeRO 0 bit for bit).  The staged specs
against the reference's ``staged_specs`` on ``jax.sharding.AbstractMesh``
with ``==``; the driver's ``--auto --hw v100`` under ``torchrun``.
"""
import dataclasses
import functools
import importlib
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.core import planner as ref_planner
from repro.core.cost_model import StrategySpec as RefStrategySpec
from repro.data import pipeline as jax_data
from repro.models import lm as ref_lm
from repro.optim import optimizer as jax_opt
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.core.schedule import make_schedule
from repro_torch.models import attention
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adafactor, adamw
from repro_torch.tree import flatten, tree_map, unflatten

from torch_harness import TOLS

# ``repro.core`` exports the ``pipeline`` scope under the module's name
ref_pipe = importlib.import_module("repro.core.pipeline")
# … and so does ``repro_torch.core``
pipe = importlib.import_module("repro_torch.core.pipeline")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
TOL = TOLS["float32"]
LR = 1e-3
B, T = 8, 16
STEPS = 3
#: the models: (kv heads, layers, tied)
MODELS = {"A": (1, 2, False), "B": (2, 2, False), "C": (1, 2, True),
          "D": (1, 3, False)}
#: name: (model, (pods, stage, data, model) mesh, schedule, µb, stage
#: layers, zero)
CASES = {4: {"gpipe_mb2": ("A", (1, 2, 1, 2), "gpipe", 2, (1, 1), 0),
             "gpipe_mb4": ("A", (1, 2, 1, 2), "gpipe", 4, (1, 1), 0),
             "1f1b_mb2": ("A", (1, 2, 1, 2), "1f1b", 2, (1, 1), 0),
             "1f1b_mb4": ("A", (1, 2, 1, 2), "1f1b", 4, (1, 1), 0),
             "grouped": ("B", (1, 2, 1, 2), "1f1b", 4, (1, 1), 0),
             "tied": ("C", (1, 2, 1, 2), "1f1b", 2, (1, 1), 0),
             "uneven": ("D", (1, 2, 1, 2), "1f1b", 4, (2, 1), 0),
             # the backward on a thread of its own, as the autograd engine
             # runs it on the card: a checkpoint's recompute must find the
             # rules there too
             "backward_thread": ("A", (1, 2, 1, 2), "1f1b", 4, (1, 1), 0)},
         8: {"pod2": ("A", (2, 2, 1, 2), "1f1b", 2, (1, 1), 0),
             "data2": ("A", (1, 2, 2, 2), "gpipe", 2, (1, 1), 0),
             "data2_zero1": ("A", (1, 2, 2, 2), "gpipe", 2, (1, 1), 1),
             "data2_zero3": ("A", (1, 2, 2, 2), "gpipe", 2, (1, 1), 3)}}
#: the cases whose checkpoints are written after their last step: the
#: uneven one (the padded layout) and an even one (resumed unpipelined)
CKPT = ("uneven", "1f1b_mb4")
#: adafactor through the pipeline over model 2 (``pipeline{split}``):
#: the model, its uneven stage layers and the steps
AF_MODEL, AF_STAGES, AF_STEPS = "D", (2, 1), 2
#: the reference's interpreter runs these: (model, schedule, µb, layers)
INTERP = {"1f1b_mb4": ("A", "1f1b", 4, (1, 1)),
          "uneven": ("D", "1f1b", 4, (2, 1))}


def _cfg(get, key: str):
    kv, n_layers, tied = MODELS[key]
    return dataclasses.replace(get(ARCH, smoke=True), n_kv_heads=kv,
                               n_layers=n_layers, tie_embeddings=tied,
                               vocab=500, remat="full")


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def ref():
    """Per model, the reference's unmeshed loss and gradients on the whole
    batch and its AdamW loop's losses over STEPS + 1 steps; its
    interpreter for INTERP."""
    tokens = np.random.default_rng(0).integers(0, 500, (B, T)).astype(
        np.int32)
    out = {"tokens": tokens}
    batch = {"tokens": jnp.asarray(tokens)}
    for i, key in enumerate(MODELS):
        jm = ref_lm.build(_cfg(jax_get_config, key))
        params = jm.init(jax.random.key(i))
        out[key, "params"] = _np(params)
        grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
        (loss, _), g = grad_fn(params, batch)
        out[key] = (float(loss), _np(g))
        opt = jax_opt.adamw(lr=LR)
        p, st, losses = params, opt.init(params), []
        for step in range(STEPS + 1):
            (loss, _), g = grad_fn(p, batch)
            p, st = opt.apply(g, st, p, step)
            losses.append(float(loss))
        out[key, "losses"] = losses
        if key == AF_MODEL:
            # the reference's adafactor on the unsharded leaves
            opt = jax_opt.adafactor(lr=LR)
            p, st, losses = params, opt.init(params), []
            for step in range(AF_STEPS):
                (loss, _), g = grad_fn(p, batch)
                p, st = opt.apply(g, st, p, step)
                losses.append(float(loss))
            out["adafactor"] = (losses, _np(p))
        for name, (k, sched, mbs, sl) in INTERP.items():
            if k == key:
                loss, grads, _ = ref_pipe.schedule_grads(
                    jm, params, batch["tokens"], micro_batches=mbs,
                    schedule=sched, stage_layers=sl)
                out[name, "interp"] = (float(loss), _np(grads))
    return out


# ---------------------------------------------------------------------------
# the port on gloo ranks
# ---------------------------------------------------------------------------

def _in_thread(fn, *args, **kw):
    """``fn(*args, **kw)`` on a new thread, which sees none of this
    thread's thread-locals."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn(*args, **kw)))
    t.start()
    t.join()
    return out[0]


def _spy(opt, seen: dict):
    """``opt`` whose ``apply`` keeps the first gradient it is handed."""
    real_apply = opt.apply

    def apply(grads, state, p, step, **kw):
        if step == 0:
            seen["grads"] = tree_map(torch.clone, grads)
        return real_apply(grads, state, p, step, **kw)

    return dataclasses.replace(opt, apply=apply)


def _plan(model, mesh_dims, sched, mbs, zero):
    pods, pp, dp, tp = mesh_dims
    strat = StrategySpec(dp=pods * dp, tp=tp, pp=pp, micro_batches=mbs,
                         schedule=sched, zero=zero)
    mesh = planner.mesh_for_strategy(strat, pods=pods, device_type="cpu")
    return planner.compile_plan(model, mesh, strat)


def _dump(res: dict, prefix: str, tree) -> None:
    for path, v in zip(*flatten(tree)):
        res[f"{prefix}/{path}"] = v.detach().numpy()


def _case(name, case, full: dict, tokens, out_dir, res, meta) -> None:
    key, mesh_dims, sched, mbs, sl, zero = case
    model = Model(_cfg(get_config, key), "cpu")
    plan = _plan(model, mesh_dims, sched, mbs, zero)
    mesh = plan.mesh
    stage = mesh.get_local_rank("stage")
    params = plan.shard(pipe.stage_state(tree_map(torch.clone, full[key]),
                                         stage, sl),
                        sharding.within_stage(plan.param_specs))
    seen = {}
    opt = _spy(adamw(lr=LR), seen)
    state = {"params": params, "opt": plan.init_opt(opt, params)}
    step = plan.pipeline_train_step_fn(opt, stage_layers=sl)
    toks = plan.batch_slice({"tokens": tokens})["tokens"]
    losses, peaks = [], []
    real = torch.autograd.backward
    if name == "backward_thread":
        torch.autograd.backward = functools.partial(_in_thread, real)
    try:
        for i in range(STEPS):
            p, o, m = step(state["params"], state["opt"], toks, i)
            state = {"params": p, "opt": o}
            losses.append(float(m["loss"]))
            peaks.append(m["peak_in_flight"])
    finally:
        torch.autograd.backward = real
    grads = pipe.gather_stages(seen["grads"], plan.param_specs, plan.rules,
                               sl)
    whole = plan.gather_pipeline_state(state, opt, sl)
    info = {"losses": losses, "peaks": peaks, "stage": stage,
            "model": mesh.get_local_rank("model"),
            "data": plan._index(),
            "shapes": [list(v.shape) for v in flatten(state)[1]]}
    with sharding.use_rules(plan.rules):
        info["layout"] = attention.choose_layout(model.cfg.attn_cfg())
    if name in CKPT:
        _dump(res, f"{name}/local", state)
        ckpt = CheckpointManager(
            os.path.join(out_dir, f"ck_{name}"), keep=1,
            rank=dist.get_rank(), barrier=dist.barrier,
            gather=lambda tree: plan.gather_pipeline_state(tree, opt, sl))
        ckpt.save(STEPS, state)
        at, back, _ = plan.restore_pipeline_state(ckpt, opt, sl)
        info["restored"] = at == STEPS and all(
            torch.equal(a, b) for a, b in zip(flatten(back)[1],
                                              flatten(state)[1]))
        if sl == (1, 1):
            info["resumed_loss"] = _resume_unpipelined(model, ckpt, tokens)
    meta[name] = info
    if dist.get_rank() == 0:
        _dump(res, f"{name}/grads", dict(grads, blocks=pipe.unpad_stage_stack(
            grads["blocks"], sl)))
        _dump(res, f"{name}/state", whole)


def _resume_unpipelined(model, ckpt, tokens) -> float:
    """The pipelined checkpoint (even stages: the standard layout) restored
    into ``replica×2{split×2}`` on the same ranks, and its next step's
    loss."""
    strat = StrategySpec(dp=2, tp=2)
    plan = planner.compile_plan(model, planner.mesh_for_strategy(
        strat, device_type="cpu"), strat)
    opt = adamw(lr=LR)
    at, st, _ = plan.restore_state(ckpt, opt)
    _, _, m = plan.train_step_fn(opt)(st["params"], st["opt"],
                                      plan.batch_slice({"tokens": tokens}),
                                      at)
    return float(m["loss"])


def _checks(full: dict, tokens, meta: dict, res: dict) -> None:
    """The pipelined start, and adafactor through ``pipeline{split}``
    (once refused) at uneven stages, on the 4 ranks."""
    model = Model(_cfg(get_config, AF_MODEL), "cpu")
    plan = _plan(model, (1, 2, 1, 2), "1f1b", 4, 0)
    got = plan.init_pipeline_params(0, stage_layers=AF_STAGES)
    whole = pipe.stage_state(Model(model.cfg, "cpu").init(0),
                             plan.mesh.get_local_rank("stage"), AF_STAGES)
    want = plan.shard(whole, sharding.within_stage(plan.param_specs))
    meta["init_equal"] = all(torch.equal(a, b) for a, b in
                             zip(flatten(got)[1], flatten(want)[1]))
    stage = plan.mesh.get_local_rank("stage")
    params = plan.shard(pipe.stage_state(
        tree_map(torch.clone, full[AF_MODEL]), stage, AF_STAGES),
        sharding.within_stage(plan.param_specs))
    opt = adafactor(lr=LR)
    state = opt.init(params)
    step = plan.pipeline_train_step_fn(opt, stage_layers=AF_STAGES)
    losses = []
    for i in range(AF_STEPS):
        params, state, m = step(params, state, tokens, i)
        losses.append(float(m["loss"]))
    meta["adafactor"] = losses
    whole = pipe.gather_stages(params, plan.param_specs, plan.rules,
                               AF_STAGES)
    if dist.get_rank() == 0:
        _dump(res, "adafactor/params", dict(
            whole, blocks=pipe.unpad_stage_stack(whole["blocks"],
                                                 AF_STAGES)))


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    d = dict(np.load(inputs))
    full = {key: params_from_numpy(
        _cfg(get_config, key), {k[len(f"{key}/"):]: v for k, v in d.items()
                                if k.startswith(f"{key}/")}, "cpu")
        for key in MODELS}
    tokens = torch.tensor(d["tokens"])
    res, meta = {}, {}
    for name, case in CASES[world].items():
        _case(name, case, full, tokens, out_dir, res, meta)
    if world == 4:
        _checks(full, tokens, meta, res)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _spawn(world: int, ref, tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp(f"nested{world}")
    np.savez(d / "inputs.npz", tokens=ref["tokens"],
             **{f"{key}/{k}": v for key in MODELS
                for k, v in ref[key, "params"].items()})
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
    return out, d


@pytest.fixture(scope="module")
def ranks4(ref, tmp_path_factory):
    return _spawn(4, ref, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks8(ref, tmp_path_factory):
    return _spawn(8, ref, tmp_path_factory)


def _tree(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=tol, rtol=tol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("world,name", [(w, n) for w in CASES
                                        for n in CASES[w]])
def test_nested_step_matches_reference(world, name, ref, request):
    """The step-0 loss and every gathered step-0 gradient leaf against the
    reference's unmeshed ``loss_fn`` (and its interpreter where it ran);
    three AdamW steps' losses against its optimizer loop; every rank
    reports the same losses, and its stage's audited buffer peak."""
    ranks, _ = request.getfixturevalue(f"ranks{world}")
    key, (pods, pp, dp, tp), sched, mbs, sl, zero = CASES[world][name]
    res, metas = ranks[0][0], [m for _, m in ranks]
    want_loss, want_g = ref[key]
    got = metas[0][name]["losses"]
    np.testing.assert_allclose(got[0], want_loss, atol=TOL.fwd, rtol=TOL.fwd)
    grads = _tree(res, f"{name}/grads/")
    _close(grads, want_g, TOL.grad, f"{name} against loss_fn")
    if name in INTERP:
        il, ig = ref[name, "interp"]
        np.testing.assert_allclose(got[0], il, atol=TOL.fwd, rtol=TOL.fwd)
        _close(grads, ig, TOL.grad, f"{name} against the interpreter")
    np.testing.assert_allclose(got, ref[key, "losses"][:STEPS],
                               atol=TOL.fwd, rtol=TOL.fwd)
    in_flight = make_schedule(sched, pp, mbs).per_stage_in_flight()
    for m in metas:
        assert m[name]["losses"] == got
        assert m[name]["peaks"] == [in_flight[m[name]["stage"]]] * STEPS
    assert metas[0][name]["layout"] == ("grouped" if key == "B"
                                        else "repeat")
    # the mesh: each (pod, data) replica's stage 2 x model 2 block
    coords = sorted((m[name]["data"], m[name]["stage"], m[name]["model"])
                    for m in metas)
    assert coords == sorted((r, s, k) for r in range(pods * dp)
                            for s in range(pp) for k in range(tp))


def test_each_rank_holds_its_rows_and_blocks(ranks4, ranks8):
    """A rank holds its stage's rows of each stacked leaf, split over
    ``model`` (heads, MLP columns; the repeat layout's wk/wv whole) and
    the vocab-split embedding and head; nothing over ``data`` under ZeRO
    1 or 3, whose losses and gathered state equal ZeRO 0's bit for bit."""
    model = Model(_cfg(get_config, "D"), "meta")
    paths = flatten({"params": model.param_shapes(),
                     "opt": adamw().init(model.param_shapes())})[0]
    for _, m in ranks4[0]:
        shapes = dict(zip(paths, m["uneven"]["shapes"]))
        rows = 2 if m["uneven"]["stage"] == 0 else 1
        assert shapes["params/embed/table"] == [256, 128]
        assert shapes["params/head/w"] == [128, 256]
        assert shapes["params/blocks/p0/attn/wq"] == [rows, 128, 2, 32]
        assert shapes["params/blocks/p0/attn/wk"] == [rows, 128, 1, 32]
        assert shapes["params/blocks/p0/mlp/wi"] == [rows, 128, 128]
        assert shapes["params/blocks/p0/norm1/scale"] == [rows, 128]
        assert shapes["opt/mu/blocks/p0/mlp/wo"] == [rows, 128, 128]
    ranks, _ = ranks8
    zero0 = ranks[0][1]["data2"]
    for res, m in ranks:
        for z in ("data2_zero1", "data2_zero3"):
            assert m[z]["losses"] == zero0["losses"]
            assert m[z]["shapes"] == m["data2"]["shapes"]
    res = ranks[0][0]
    want = _tree(res, "data2/state/")
    for z in ("data2_zero1", "data2_zero3"):
        got = _tree(res, f"{z}/state/")
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=f"{z} {path}")


def test_pipelined_start_and_refusals(ranks4, ref):
    """``init_pipeline_params`` keeps this rank's rows and block of the
    whole model drawn once; adafactor over a split model (once refused)
    through ``pipeline{split}`` at uneven stages (2, 1): its losses and
    the gathered parameters after AF_STEPS steps against the reference's
    adafactor on the unsharded leaves (its means the whole leaf's across
    the stages and the model blocks)."""
    want_losses, want_p = ref["adafactor"]
    for _, m in ranks4[0]:
        assert m["init_equal"]
        np.testing.assert_allclose(m["adafactor"], want_losses,
                                   atol=TOL.fwd, rtol=TOL.fwd)
    _close(_tree(ranks4[0][0][0], "adafactor/params/"), want_p, TOL.grad,
           "adafactor through pipeline{split}")


def _assemble(ranks: list, name: str, sl: tuple) -> dict:
    """The padded whole of a case's state from every rank's blocks: the
    model blocks joined along the dim the staged spec splits, each
    stage's rows padded to the longest stage."""
    model = Model(_cfg(get_config, CASES[4][name][0]), "meta")
    rules = sharding.rules_for_strategy({"stage": 2, "data": 1, "model": 2},
                                        StrategySpec(tp=2, pp=2))
    opt = adamw()
    specs = dict(zip(*flatten(sharding.staged_specs(
        rules, {"params": model.axes(),
                "opt": opt.state_axes(model.axes())},
        {"params": model.param_shapes(),
         "opt": opt.init(model.param_shapes())}))))
    local = {(m[name]["stage"], m[name]["model"]): _tree(res,
                                                         f"{name}/local/")
             for res, m in ranks}
    lmax = max(sl)
    out = {}
    for path, spec in specs.items():
        dims = [i for i, e in enumerate(spec) if e == "model"]
        per_stage = []
        for s in range(len(sl)):
            blocks = [local[s, k][path] for k in range(2)]
            x = np.concatenate(blocks, dims[0]) if dims else blocks[0]
            if "blocks" in path.split("/"):
                pad = np.zeros((lmax - x.shape[0],) + x.shape[1:], x.dtype)
                x = np.concatenate([x, pad])
            per_stage.append(x)
        out[path] = (np.concatenate(per_stage)
                     if "blocks" in path.split("/") else per_stage[0])
    return out


def test_checkpoint_round_trips_between_packages(ranks4, ref):
    """The pipelined checkpoint, read by the reference's
    ``CheckpointManager`` into ``pipeline_params``' padded layout, equals
    the ranks' blocks assembled (pad rows zero) and the port's gather; it
    restores into the ranks' blocks bit for bit, and, at even stages,
    into the unpipelined ``replica×2{split×2}``, whose next step's loss is
    the reference's fourth."""
    ranks, d = ranks4
    res0 = ranks[0][0]
    for name in CKPT:
        key, _, _, _, sl, _ = CASES[4][name]
        jm = ref_lm.build(_cfg(jax_get_config, key))
        params = unflatten(*zip(*ref[key, "params"].items()))
        padded = ref_pipe.pipeline_params(
            jm, jax.tree.map(jnp.asarray, params), sl)
        target = {"params": padded, "opt": jax_opt.adamw().init(padded)}
        step, tree, _ = JaxCheckpointManager(
            str(d / f"ck_{name}")).restore_latest(target)
        assert step == STEPS
        got = _np(tree)
        want = _assemble(ranks, name, sl)
        gathered = _tree(res0, f"{name}/state/")
        assert sorted(got) == sorted(want) == sorted(gathered)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=f"{name} {path}")
            np.testing.assert_array_equal(gathered[path], want[path],
                                          err_msg=f"{name} {path}")
        if sl == (2, 1):                        # stage 1's pad row
            assert not any(v[3:].any() for p, v in got.items()
                           if "blocks" in p.split("/"))
        for _, m in ranks:
            assert m[name]["restored"], name
    resumed = [m["1f1b_mb4"]["resumed_loss"] for _, m in ranks]
    np.testing.assert_allclose(resumed, [ref["A", "losses"][STEPS]] * 4,
                               atol=TOL.fwd, rtol=TOL.fwd)


# ---------------------------------------------------------------------------
# the layout: the reference's staged specs with ==
# ---------------------------------------------------------------------------

SPEC_MESHES = {"stage2_model2": ((2, 2), ("stage", "model")),
               "stage2_data2_model2": ((2, 2, 2), ("stage", "data",
                                                   "model")),
               "pod2_stage2_model4": ((2, 2, 1, 4), ("pod", "stage", "data",
                                                     "model"))}


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
@pytest.mark.parametrize("zero", [0, 1, 3])
def test_staged_specs_equal_reference(mesh, zero):
    """The plan's parameter and AdamW specs under a pipeline are the
    reference's ``staged_specs`` (tinyllama-1.1b at full size, stage
    layers (12, 10)), whatever the ZeRO stage."""
    sizes, axes = SPEC_MESHES[mesh]
    shape = dict(zip(axes, sizes))
    kw = dict(dp=shape.get("pod", 1) * shape.get("data", 1),
              tp=shape["model"], pp=shape["stage"], zero=zero)
    jm = ref_lm.build(jax_get_config(ARCH))
    rplan = ref_planner.compile_plan(jm, AbstractMesh(sizes, axes),
                                     RefStrategySpec(**kw))
    pshapes = ref_pipe._padded_model_shapes(jm, (12, 10))
    want = ref_pipe.staged_specs(rplan.rules, jm.axes(), pshapes)
    opt = jax_opt.adamw()
    want_opt = ref_pipe.staged_specs(rplan.rules, opt.state_axes(jm.axes()),
                                     jax.eval_shape(opt.init, pshapes))
    strat = StrategySpec(**kw)
    plan = planner.ExecutionPlan(
        model=Model(get_config(ARCH), "meta"), mesh=None, strategy=strat,
        rules=sharding.rules_for_strategy(shape, strat))
    assert _specs(plan.param_specs) == _specs(want)
    assert _specs(plan.state_layout(adamw())) == _specs(want_opt)
    assert not any(a in ("data", "pod") for spec in flatten(
        plan.state_layout(adamw()))[1] for e in spec
        for a in sharding._axes(e))


# ---------------------------------------------------------------------------
# the driver under torchrun
# ---------------------------------------------------------------------------

DRIVER_STEPS, DRIVER_M = 3, 4


def _driver_reference(ck: str) -> list:
    """A step-0 checkpoint of the reference's smoke weights in ``ck`` (the
    driver resumes from it) and the reference's unmeshed loop's losses:
    the driver's schedule and token stream, the mean over DRIVER_M
    micro-batches."""
    cfg = jax_get_config(ARCH, smoke=True)
    jm = ref_lm.build(cfg)
    params = jm.init(jax.random.key(0))
    sched = jax_opt.Schedule(base_lr=3e-4,
                             warmup=min(100, DRIVER_STEPS // 10 + 1),
                             decay_steps=DRIVER_STEPS)
    opt = jax_opt.adamw(lr=sched)
    data = jax_data.TokenPipeline(
        jax_data.DataCfg(global_batch=4, seq_len=32, vocab=cfg.vocab,
                         seed=0), host_id=0, n_hosts=1)
    JaxCheckpointManager(ck).save(0, {"params": params,
                                      "opt": opt.init(params)},
                                  extra={"data": data.state_dict()})
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    state, losses = opt.init(params), []
    for i in range(DRIVER_STEPS):
        toks = jnp.asarray(data.next_batch()["tokens"])
        outs = [grad_fn(params, {"tokens": t})
                for t in jnp.split(toks, DRIVER_M)]
        g = jax.tree.map(lambda *x: sum(x) / DRIVER_M, *(g for _, g in outs))
        params, state = opt.apply(g, state, params, i)
        losses.append(float(sum(loss for (loss, _), _ in outs) / DRIVER_M))
    return losses


def test_train_driver_auto_v100_trains_the_nested_hybrid(tmp_path):
    """``--auto --hw v100`` on 4 gloo ranks picks ``split×2
    pipeline×2(µb=4)`` for the smoke model at batch 4 x 32 and trains it
    from the reference's weights (a step-0 checkpoint in the pipelined
    layout, which even stages leave standard), matching the reference's
    unmeshed loop; ``--compress-pod`` beside a pipeline exits."""
    ck = str(tmp_path / "ck")
    want = _driver_reference(ck)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--auto", "--hw", "v100", "--batch", "4",
         "--seq", "32", "--steps", str(DRIVER_STEPS), "--log-every", "1",
         "--ckpt-dir", ck], capture_output=True, text=True, timeout=300,
        env=env, cwd=str(tmp_path))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    out = p.stdout
    assert "[auto] chose: split×2 pipeline×2(µb=4)\n" in out
    assert "[plan] mesh {'stage': 2, 'data': 1, 'model': 2}; split×2 over " \
           "model (heads, MLP columns, vocab); pipeline×2 over stage, " \
           "stage layers (1, 1)" in out
    assert "[resume] from step 0" in out
    got = [float(line.split()[3]) for line in out.splitlines()
           if line.strip().startswith("step ")]
    tol = TOLS["float32"].grad
    np.testing.assert_allclose(got, want, atol=tol + 5e-5, rtol=tol)
    assert (tmp_path / "ck" / f"step_{DRIVER_STEPS:08d}.COMMITTED").exists()
    with pytest.raises(SystemExit, match="no compressed cross-pod"):
        from repro_torch.launch import train
        train.main(["--smoke", "--device", "cpu", "--pp", "2",
                    "--compress-pod", "--ckpt-dir", str(tmp_path / "x")])
