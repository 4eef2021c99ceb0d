"""The MoE family across the port's engine against the reference on the
CPU: the experts' balance over the global batch at ``dp > 1``,
deepseek-moe-16b in a pipeline (also ``pipeline{split[experts]}``), and
deepseek served over a data × model mesh.

The model is the smoke deepseek-moe-16b (8 experts, top-2, 1 shared
expert, 4 heads over 4 kv heads) in f32, remat none, its weights drawn by
the reference and carried across by ``params_from_numpy``; the batch is
8 × 16 seeded numpy tokens.  Tolerances f32 (tests/torch_harness.py):
values 2e-5, gradients 2e-4.

- The schedule interpreter ``schedule_grads`` at pp 2 against the
  reference's ``schedule_grads``, gpipe and 1f1b, stages (1, 1) on the
  2-layer smoke config and (2, 1) on a 3-layer one: loss, every gradient
  leaf, and ``moe_lb``/``moe_z`` against the reference's aux (the mean
  over micro-batches of its ``loss_fn``'s, what its fused engine adds as
  ``psum(aux, "stage") / M``).
- One spawn of 2 gloo ranks: the multi-rank engine at pp 2 (gpipe and
  1f1b even, 1f1b (2, 1)); data 2 against the reference's ``loss_fn`` on
  the whole global batch, and the old per-replica balance planted (no
  mean over data) missing it by more than the tolerance while it meets
  the mean of the reference over the two replicas' rows; the refusals of
  uneven shares and of a ``loss_mask`` over data replicas; serving at
  model 2.
- One spawn of 4 gloo ranks: pp 2 × model 2 (experts 4 a rank inside a
  stage), its pipelined checkpoint gathered and restored bit for bit;
  dp 2 × pp 2; ``StrategySpec(dp=2, ep=2)`` (the M6 nesting); serving at
  data 2 × model 2.
- Serving: prefill logits and cache, 6 teacher-forced dense steps with
  the cache's sequence split (24 rows) and its kv heads split (23 rows),
  6 paged steps, against the reference's unmeshed functions; the Server's
  greedy tokens, dense and paged, equal to the reference's ``Server``.
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
from jax.sharding import AbstractMesh

from repro.core import planner as ref_planner
from repro.core.cost_model import StrategySpec as RefStrategySpec
from repro.models import lm as ref_lm
from repro.serving.server import Request as RefRequest
from repro.serving.server import Server as RefServer
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro.optim import optimizer as jax_opt
from repro_torch.serving.server import Request, Server
from repro_torch.tree import flatten, tree_map

from torch_harness import TOLS

ref_pipe = importlib.import_module("repro.core.pipeline")
pipe = importlib.import_module("repro_torch.core.pipeline")

ARCH = "deepseek-moe-16b"
TOL = TOLS["float32"]
B, T, M = 8, 16, 2
#: the interpreter's cases: (layers, schedule, stage layers)
INTERP = [(2, "gpipe", (1, 1)), (2, "1f1b", (1, 1)), (3, "gpipe", (2, 1)),
          (3, "1f1b", (2, 1))]
#: the engine's cases: name -> (world, pp, dp, model, layers, schedule,
#: stage layers)
ENGINE = {"pp2_gpipe": (2, 2, 1, 1, 2, "gpipe", (1, 1)),
          "pp2_1f1b": (2, 2, 1, 1, 2, "1f1b", (1, 1)),
          "pp2_1f1b_21": (2, 2, 1, 1, 3, "1f1b", (2, 1)),
          "pp2_tp2": (4, 2, 1, 2, 2, "1f1b", (1, 1)),
          "dp2_pp2": (4, 2, 2, 1, 2, "1f1b", (1, 1))}
#: the unpipelined data-parallel steps: name -> (world, strategy)
DATA = {"dp2": (2, StrategySpec(dp=2)),
        "dp2_ep2": (4, StrategySpec(dp=2, tp=2, ep=2))}
#: the rows of the global batch each reference micro-batch takes at
#: dp 2 × pp 2: micro-batch m holds data rank 0's m-th slice, then rank 1's
PERM = [0, 1, 4, 5, 2, 3, 6, 7]
# serving
SB, SS = 4, 16                    # prefill slots and prompt bucket
LAST = [9, 15, 4, 12]
STEPS = 6
DENSE_GB = {"seq": 8, "heads": 7}
PS, MP, P = 4, 8, 29
SERVERS = {"dense": ("dense", 32), "paged": ("paged", 32)}
SPEC = [(6, 10), (9, 10), (12, 10), (5, 10), (7, 8)]
#: the serving meshes: world -> (data, model)
SERVE = {2: (1, 2), 4: (2, 2)}


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


def _cfgs(layers: int = 2):
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True),
                                n_layers=layers),
            dataclasses.replace(get_config(ARCH, smoke=True),
                                n_layers=layers))


def _ref_aux(jm, params, tokens) -> tuple:
    """The reference's experts' aux over M micro-batches of ``tokens``:
    the mean of its ``loss_fn``'s ``moe_lb`` and ``moe_z``."""
    mets = [jm.loss_fn(params, {"tokens": jnp.asarray(t)})[1]
            for t in np.split(tokens, M)]
    return (float(np.mean([m["moe_lb"] for m in mets])),
            float(np.mean([m["moe_z"] for m in mets])))


def _drive(server, params, prompts, request) -> dict:
    pending = [request(i, p.astype(np.int32), max_new=g)
               for i, (p, (_, g)) in enumerate(zip(prompts, SPEC))]
    done = []
    for _ in range(1000):
        if not (pending or server.active):
            break
        while (pending and (slot := server.free_slot()) is not None
               and server.can_admit(pending[0])):
            req = pending.pop(0)
            server.admit(params, req, slot)
            if req.done:
                done.append(req)
        done.extend(server.step(params))
        pending[:0] = server.take_requeued()
    else:
        raise AssertionError("drive did not converge")
    return {str(r.rid): [int(t) for t in r.out_tokens] for r in done}


def _paged_state(cache: np.ndarray, pos: np.ndarray):
    """Pools holding each live slot's prefill rows in scattered pages and
    its table; slot SB-1 is inactive."""
    rng = np.random.default_rng(7)
    free = list(rng.permutation(np.arange(1, P)))
    table = np.zeros((SB, MP), np.int32)
    pool = np.zeros((cache.shape[0], P, PS) + cache.shape[3:], np.float32)
    for b in range(SB - 1):
        n = -(-(pos[b] + STEPS) // PS)
        table[b, :n] = [free.pop() for _ in range(n)]
        for j in range(-(-SS // PS)):
            pool[:, table[b, j]] = cache[:, b, j * PS:(j + 1) * PS]
    return pool, table


def _ref_serving(jm, jp, out: dict) -> None:
    rng = np.random.default_rng(3)
    V = jm.cfg.vocab
    out["s_tokens"] = rng.integers(0, V, (SB, SS)).astype(np.int32)
    out["s_steps"] = rng.integers(0, V, (STEPS, SB)).astype(np.int32)
    out["prompts"] = [rng.integers(0, V, n) for n, _ in SPEC]
    step = jax.jit(jm.serve_step)
    for gb in (0, *DENSE_GB.values()):
        logits, st = jm.prefill(jp, {"tokens": jnp.asarray(out["s_tokens"])},
                                gen_budget=gb, last_idx=jnp.asarray(LAST))
        out["prefill", gb] = (np.asarray(logits), _np(st["cache"]["p0"]))
        if gb == 0:
            continue
        lg = []
        for t in range(STEPS):
            logits, st = step(jp, jnp.asarray(out["s_steps"][t]), st)
            lg.append(np.asarray(logits))
        out["dense", gb] = np.stack(lg)
    pos = np.asarray(LAST, np.int32) + 1
    pos[-1] = 0
    pools, table = {}, None
    for key in ("k", "v"):
        pools[key], table = _paged_state(out["prefill", 0][1][key], pos)
    out["paged_in"] = (pools, table, pos)
    jstate = {"pools": {"p0": {k: jnp.asarray(v) for k, v in pools.items()}},
              "block_table": jnp.asarray(table), "pos": jnp.asarray(pos)}
    lg = []
    for t in range(STEPS):
        logits, jstate = jm.serve_step_paged(
            jp, jnp.asarray(out["s_steps"][t]), jstate)
        lg.append(np.asarray(logits))
        jstate["pos"] = jstate["pos"].at[SB - 1].set(0)
    out["paged"] = np.stack(lg)
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    rplan = ref_planner.compile_plan(jm, mesh)
    for name, (cache, max_len) in SERVERS.items():
        server = RefServer(jm, rplan, batch_slots=SB, max_len=max_len,
                           cache=cache, page_size=PS)
        out["server", name] = _drive(server, jp, out["prompts"], RefRequest)


@pytest.fixture(scope="module")
def ref():
    """The reference on the same weights and tokens: ``loss_fn`` and its
    gradients on the whole batch and on each half, its interpreter for
    every case (and on the rows in PERM's order), their aux, and its
    unmeshed serving."""
    out = {"tokens": np.random.default_rng(0).integers(
        0, 512, (B, T)).astype(np.int32)}
    toks = out["tokens"]
    for layers in (2, 3):
        jcfg, _ = _cfgs(layers)
        jm = ref_lm.build(jcfg)
        jp = jax.jit(jm.init)(jax.random.key(layers))
        out["params", layers] = _np(jp)
        for _, sched, sl in (c for c in INTERP if c[0] == layers):
            loss, g, _ = ref_pipe.schedule_grads(
                jm, jp, jnp.asarray(toks), micro_batches=M, schedule=sched,
                stage_layers=sl)
            out[sched, sl, layers] = (float(loss), _np(g),
                                      _ref_aux(jm, jp, toks))
        if layers == 3:
            continue
        loss, g, _ = ref_pipe.schedule_grads(
            jm, jp, jnp.asarray(toks[PERM]), micro_batches=M,
            schedule="1f1b", stage_layers=(1, 1))
        out["perm"] = (float(loss), _np(g), _ref_aux(jm, jp, toks[PERM]))
        grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
        (loss, m), g = grad_fn(jp, {"tokens": jnp.asarray(toks)})
        out["whole"] = (float(loss), {k: float(v) for k, v in m.items()},
                        _np(g))
        halves = [grad_fn(jp, {"tokens": jnp.asarray(t)})
                  for t in np.split(toks, 2)]
        out["halves"] = (float(np.mean([h[0][0] for h in halves])),
                         {k: np.mean([_np(h[1])[k] for h in halves], 0)
                          for k in out["whole"][2]})
        _ref_serving(jm, jp, out)
    return out


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=tol, rtol=tol,
                                   err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# the layout of the expert leaves in a pipeline
# ---------------------------------------------------------------------------

def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("model_axis", [1, 2, 4])
def test_staged_specs_of_the_experts_equal_reference(model_axis):
    """deepseek-moe-16b at full size, stage 2 × model 1, 2 or 4, stage
    layers (15, 13): the plan's parameter and AdamW specs are the
    reference's ``staged_specs``: the router whole, the experts' stacked
    dim over ``model`` (whole experts a rank), their ``expert_mlp`` whole
    (first come wins), the shared experts column- and row-parallel."""
    sizes, axes = (2, 1, model_axis), ("stage", "data", "model")
    kw = dict(tp=model_axis, pp=2, ep=model_axis)
    jm = ref_lm.build(jax_get_config(ARCH))
    rplan = ref_planner.compile_plan(jm, AbstractMesh(sizes, axes),
                                     RefStrategySpec(**kw))
    pshapes = ref_pipe._padded_model_shapes(jm, (15, 13))
    want = ref_pipe.staged_specs(rplan.rules, jm.axes(), pshapes)
    opt = jax_opt.adamw()
    want_opt = ref_pipe.staged_specs(rplan.rules, opt.state_axes(jm.axes()),
                                     jax.eval_shape(opt.init, pshapes))
    strat = StrategySpec(**kw)
    plan = planner.ExecutionPlan(
        model=Model(get_config(ARCH), "meta"), mesh=None, strategy=strat,
        rules=sharding.rules_for_strategy(dict(zip(axes, sizes)), strat))
    assert _specs(plan.param_specs) == _specs(want)
    assert _specs(plan.state_layout(adamw())) == _specs(want_opt)
    moe = plan.param_specs["blocks"]["p0"]["moe"]
    assert moe["router"]["w"] == ("stage", None, None)
    assert moe["w_in"] == ("stage", "model", None, None)


@pytest.mark.parametrize("sl", [(2, 1), (1, 2)])
def test_padded_stage_layout_of_the_experts_matches_reference(sl, ref):
    """The 3-layer smoke model's padded pipeline layout (the pipelined
    checkpoint's) and each stage's rows, the router, the experts and the
    shared experts included, bit for bit against the reference's
    ``pipeline_params``; ``stage_layers_from_alloc`` as the reference's."""
    want_params = ref["params", 3]
    _, cfg = _cfgs(3)
    model = Model(cfg, "cpu")
    params = params_from_numpy(cfg, want_params, "cpu")
    jparams = {}
    for path, v in want_params.items():
        node = jparams
        *parents, leaf = path.split("/")
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = jnp.asarray(v)
    want = _np(ref_pipe.pipeline_params(None, jparams, sl))
    got = {p: v.numpy() for p, v in zip(*flatten(pipe.pipeline_params(
        None, params, sl)))}
    assert sorted(got) == sorted(want)
    assert any("/moe/w_in" in p for p in got)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    for s in range(2):
        rows = pipe.stage_state(params, s, sl)["blocks"]["p0"]["moe"]
        off = sum(sl[:s])
        np.testing.assert_array_equal(
            rows["w_in"].numpy(),
            want_params["blocks/p0/moe/w_in"][off:off + sl[s]])
    jm = ref_lm.build(_cfgs(3)[0])
    assert pipe.stage_layers_from_alloc(model.stack, sl) == \
        ref_pipe.stage_layers_from_alloc(jm.stack, sl)


# ---------------------------------------------------------------------------
# the schedule interpreter, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers,sched,sl", INTERP)
def test_interpreter_matches_reference(layers, sched, sl, ref):
    _, cfg = _cfgs(layers)
    model = Model(cfg, "cpu")
    params = params_from_numpy(cfg, ref["params", layers], "cpu")
    loss, grads, stats = pipe.schedule_grads(
        model, params, torch.tensor(ref["tokens"]), micro_batches=M,
        schedule=sched, stage_layers=sl)
    want_loss, want_g, (lb, z) = ref[sched, sl, layers]
    np.testing.assert_allclose(float(loss), want_loss, atol=TOL.fwd,
                               rtol=TOL.fwd)
    np.testing.assert_allclose(float(stats["moe_lb"]), lb, atol=TOL.fwd,
                               rtol=TOL.fwd)
    np.testing.assert_allclose(float(stats["moe_z"]), z, atol=TOL.fwd,
                               rtol=TOL.fwd)
    assert float(stats["moe_lb"]) > 0 and float(stats["moe_z"]) > 0
    _close({p: v.numpy() for p, v in zip(*flatten(grads))}, want_g,
           TOL.grad, f"{sched} {sl}")


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

def _spy(opt, seen: dict):
    real_apply = opt.apply

    def apply(grads, state, p, step, **kw):
        seen["grads"] = tree_map(torch.clone, grads)
        return real_apply(grads, state, p, step, **kw)

    return dataclasses.replace(opt, apply=apply)


def _engine_case(name: str, d: dict, res: dict, meta: dict,
                 ckpt_dir: str) -> None:
    _, pp, dp, mp, layers, sched, sl = ENGINE[name]
    _, cfg = _cfgs(layers)
    model = Model(cfg, "cpu")
    strat = StrategySpec(dp=dp, tp=mp, ep=mp, pp=pp, micro_batches=M,
                         schedule=sched)
    plan = planner.compile_plan(
        model, planner.mesh_for_strategy(strat, device_type="cpu"), strat)
    full = params_from_numpy(cfg, {k.split("/", 1)[1]: v for k, v in
                                   d.items() if k.startswith(f"p{layers}/")},
                             "cpu")
    stage = plan.mesh.get_local_rank("stage")
    params = plan.shard(pipe.stage_state(full, stage, sl),
                        sharding.within_stage(plan.param_specs))
    seen = {}
    opt = _spy(adamw(lr=1e-3), seen)
    state = {"params": params, "opt": opt.init(params)}
    step = plan.pipeline_train_step_fn(opt, stage_layers=sl)
    toks = plan.batch_slice({"tokens": torch.tensor(d["tokens"])})["tokens"]
    p, o, m = step(state["params"], state["opt"], toks, 0)
    state = {"params": p, "opt": o}
    meta[name] = {k: float(m[k]) for k in ("loss", "moe_lb", "moe_z")}
    grads = pipe.gather_stages(seen["grads"], plan.param_specs, plan.rules,
                               sl)
    if name == "pp2_tp2":
        ckpt = CheckpointManager(
            os.path.join(ckpt_dir, name), keep=1, rank=dist.get_rank(),
            barrier=dist.barrier,
            gather=lambda tree: plan.gather_pipeline_state(tree, opt, sl))
        ckpt.save(1, state)
        at, back, _ = plan.restore_pipeline_state(ckpt, opt, sl)
        meta[name]["restored"] = at == 1 and all(
            torch.equal(a, b) for a, b in zip(flatten(back)[1],
                                              flatten(state)[1]))
        meta[name]["experts_local"] = int(
            state["params"]["blocks"]["p0"]["moe"]["w_in"].shape[1])
    if dist.get_rank() == 0:
        grads = dict(grads, blocks=pipe.unpad_stage_stack(grads["blocks"],
                                                          sl))
        for path, v in zip(*flatten(grads)):
            res[f"{name}/{path}"] = v.numpy()


def _data_case(name: str, d: dict, res: dict, meta: dict,
               balance=True) -> None:
    _, strat = DATA[name]
    _, cfg = _cfgs(2)
    model = Model(cfg, "cpu")
    plan = planner.compile_plan(
        model, planner.mesh_for_strategy(strat, device_type="cpu"), strat)
    full = params_from_numpy(cfg, {k.split("/", 1)[1]: v for k, v in
                                   d.items() if k.startswith("p2/")}, "cpu")
    params = plan.shard(full, plan.param_specs)
    seen = {}
    opt = _spy(adamw(lr=1e-3), seen)
    step = plan.train_step_fn(opt)
    batch = plan.batch_slice({"tokens": torch.tensor(d["tokens"])})
    real = sharding.batch_splits
    if not balance:                       # the old per-replica balance
        sharding.batch_splits = lambda: ()
    try:
        _, _, m = step(params, plan.init_opt(opt, params), batch, 0)
    finally:
        sharding.batch_splits = real
    tag = name if balance else f"{name}_local"
    meta[tag] = {"loss": float(m["loss"])}
    grads = tree_map(lambda g, s: sharding.gather_leaf(g, s, plan.rules),
                     seen["grads"], plan.param_specs)
    if dist.get_rank() == 0:
        for path, v in zip(*flatten(grads)):
            res[f"{tag}/{path}"] = v.numpy()


def _refusals(d: dict, meta: dict) -> None:
    """Uneven shares and a ``loss_mask`` over data replicas, for the moe
    family at data 2."""
    import types
    _, cfg = _cfgs(2)
    model = Model(cfg, "cpu")
    strat = StrategySpec(dp=2)
    mesh = planner.mesh_for_strategy(strat, device_type="cpu")
    group = types.SimpleNamespace(n_devices=1)
    placement = types.SimpleNamespace(
        spec=types.SimpleNamespace(groups=[group, group]),
        batch_shares=(8, 0), layer_alloc=())
    plan = planner.ExecutionPlan(model=model, mesh=mesh, strategy=strat,
                                 placement=placement)
    try:
        plan.train_step_fn(adamw())
    except ValueError as e:
        meta["uneven_refused"] = str(e)
    plan = planner.compile_plan(model, mesh, strat)
    tokens = torch.tensor(d["tokens"])
    batch = plan.batch_slice({"tokens": tokens,
                              "loss_mask": torch.ones_like(tokens)})
    params = model.init(0)
    try:
        plan.train_step_fn(adamw())(params, adamw().init(params), batch, 0)
    except ValueError as e:
        meta["mask_refused"] = str(e)


def _serve_case(d: dict, res: dict, meta: dict) -> None:
    shape = SERVE[dist.get_world_size()]
    _, cfg = _cfgs(2)
    model = Model(cfg, "cpu")
    plan = planner.compile_plan(model, make_mesh(shape, ("data", "model"),
                                                 device_type="cpu"))
    full = params_from_numpy(cfg, {k.split("/", 1)[1]: v for k, v in
                                   d.items() if k.startswith("p2/")}, "cpu")
    params = model.serving_params(plan.shard(full, plan.param_specs))
    meta["experts_local"] = int(params["blocks"]["p0"]["moe"]["w_in"]
                                .shape[1])
    lo, hi = plan.slot_block(SB)
    steps = torch.tensor(d["s_steps"]).long()
    group = plan.rules.group("model")
    for gb in (0, *DENSE_GB.values()):
        logits, st = plan.prefill_fn(gb)(
            params, {"tokens": torch.tensor(d["s_tokens"])},
            last_idx=torch.tensor(LAST))
        res[f"prefill{gb}/logits"] = logits.numpy()
        for k, v in st["cache"]["p0"].items():
            res[f"prefill{gb}/{k}"] = sharding.gather_cat(v, group,
                                                          3).numpy()
    for name, gb in DENSE_GB.items():
        specs = plan.state_specs(SB, SS + gb)
        whole = {"cache": {"p0": {k: torch.tensor(d[f"dense{gb}/{k}"])
                                  for k in ("k", "v")}},
                 "pos": torch.tensor(LAST, dtype=torch.int32) + 1}
        state = tree_map(lambda x, s: sharding.shard_leaf(x, s, plan.rules),
                         whole, specs)
        meta[f"dense_{name}_spec"] = list(specs["cache"]["p0"]["k"])
        step = plan.serve_step_fn(SB, SS + gb)
        lg = []
        for t in range(STEPS):
            logits, state = step(params, steps[t, lo:hi], state)
            lg.append(plan.gather_slots(logits))
        res[f"dense_{name}/logits"] = torch.stack(lg).numpy()
    specs = plan.paged_state_specs(SB, P, PS, MP)
    pools = {"p0": {k: sharding.shard_leaf(torch.tensor(d[f"pool/{k}"]),
                                           specs["pools"]["p0"][k],
                                           plan.rules) for k in ("k", "v")}}
    pos = d["paged_pos"].copy()
    step = plan.serve_step_paged_fn(SB, P, PS, MP)
    lg = []
    for t in range(STEPS):
        state = {"pools": pools,
                 "block_table": torch.tensor(d["table"][lo:hi]),
                 "pos": torch.tensor(pos[lo:hi])}
        logits, _ = step(params, steps[t, lo:hi], state)
        lg.append(plan.gather_slots(logits))
        pos[:SB - 1] += 1
    res["paged/logits"] = torch.stack(lg).numpy()
    prompts = [d[f"prompt{i}"] for i in range(len(SPEC))]
    for name, (cache, max_len) in SERVERS.items():
        server = Server(model, plan, batch_slots=SB, max_len=max_len,
                        cache=cache, page_size=PS)
        meta[f"server_{name}"] = _drive(server, params, prompts, Request)


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    d = dict(np.load(inputs))
    res, meta = {}, {}
    for name, case in ENGINE.items():
        if case[0] == world:
            _engine_case(name, d, res, meta, out_dir)
    for name, (w, _) in DATA.items():
        if w == world:
            _data_case(name, d, res, meta)
    if world == 2:
        _data_case("dp2", d, res, meta, balance=False)
        _refusals(d, meta)
    _serve_case(d, res, meta)
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _spawn(world: int, ref, tmp_path_factory) -> tuple:
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp(f"moe_engine{world}")
    pools, table, pos = ref["paged_in"]
    arrays = {"tokens": ref["tokens"], "s_tokens": ref["s_tokens"],
              "s_steps": ref["s_steps"], "table": table, "paged_pos": pos,
              **{f"p{n}/{k}": v for n in (2, 3)
                 for k, v in ref["params", n].items()},
              **{f"prompt{i}": p for i, p in enumerate(ref["prompts"])},
              **{f"pool/{k}": v for k, v in pools.items()}}
    for gb in DENSE_GB.values():
        for k, v in ref["prefill", gb][1].items():
            arrays[f"dense{gb}/{k}"] = v
    np.savez(d / "inputs.npz", **arrays)
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
    metas = []
    for r in range(world):
        with open(d / f"rank{r}.json") as f:
            metas.append(json.load(f))
    return world, dict(np.load(d / "rank0.npz")), metas


@pytest.fixture(scope="module")
def ranks2(ref, tmp_path_factory):
    return _spawn(2, ref, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(ref, tmp_path_factory):
    return _spawn(4, ref, tmp_path_factory)


def _grads(res: dict, name: str) -> dict:
    return {k[len(name) + 1:]: v for k, v in res.items()
            if k.startswith(f"{name}/")}


@pytest.mark.parametrize("name", list(ENGINE))
def test_engine_matches_reference_schedule_grads(name, ref, request):
    """Loss, ``moe_lb``, ``moe_z`` on every rank and the gathered gradient
    against the reference's ``schedule_grads``.  dp 2 × pp 2 is held
    against it on the global batch with its rows permuted (PERM): the
    reference's micro-batch m then holds exactly the rows that the port's
    data ranks hold for m, so each micro-batch's experts balance over the
    same rows in both."""
    w, _, dp, _, layers, sched, sl = ENGINE[name]
    _, res, metas = request.getfixturevalue(f"ranks{w}")
    want_loss, want_g, (lb, z) = (ref["perm"] if dp > 1
                                  else ref[sched, sl, layers])
    for m in metas:
        got = m[name]
        np.testing.assert_allclose(got["loss"], want_loss, atol=TOL.fwd,
                                   rtol=TOL.fwd)
        np.testing.assert_allclose(got["moe_lb"], lb, atol=TOL.fwd,
                                   rtol=TOL.fwd)
        np.testing.assert_allclose(got["moe_z"], z, atol=TOL.fwd,
                                   rtol=TOL.fwd)
    _close(_grads(res, name), want_g, TOL.grad, name)


def test_pipelined_checkpoint_round_trip_with_split_experts(ranks4):
    """pp 2 × model 2: each rank holds 4 of the 8 experts of its stage's
    layer; the pipelined checkpoint, gathered over model and stage onto
    rank 0, restores into every rank's blocks bit for bit."""
    _, _, metas = ranks4
    assert all(m["pp2_tp2"]["restored"] for m in metas)
    assert all(m["pp2_tp2"]["experts_local"] == 4 for m in metas)


@pytest.mark.parametrize("name", list(DATA))
def test_data_parallel_balances_the_global_batch(name, ref, request):
    """At data 2, and at data 2 × model 2 with the experts split (the M6
    nesting, ``StrategySpec(dp=2, ep=2)``): the step's loss and every
    gradient leaf equal the reference's ``loss_fn`` on the whole global
    batch."""
    _, res, metas = request.getfixturevalue(f"ranks{DATA[name][0]}")
    want_loss, _, want_g = ref["whole"]
    for m in metas:
        np.testing.assert_allclose(m[name]["loss"], want_loss, atol=TOL.fwd,
                                   rtol=TOL.fwd)
    _close(_grads(res, name), want_g, TOL.grad, name)


def test_per_replica_balance_misses_the_global_batch(ranks2, ref):
    """The old per-replica balance, planted (no mean over data): it meets
    the mean of the reference over the two replicas' rows and misses the
    global batch's loss and router gradient by more than the
    tolerance."""
    _, res, metas = ranks2
    got = _grads(res, "dp2_local")
    loss = metas[0]["dp2_local"]["loss"]
    half_loss, half_g = ref["halves"]
    np.testing.assert_allclose(loss, half_loss, atol=TOL.fwd, rtol=TOL.fwd)
    _close(got, half_g, TOL.grad, "per-replica")
    want_loss, _, want_g = ref["whole"]
    assert abs(loss - want_loss) > TOL.fwd * (1 + abs(want_loss))
    router = "blocks/p0/moe/router/w"
    gap = np.abs(got[router] - want_g[router])
    assert (gap > TOL.grad * (1 + np.abs(want_g[router]))).any()


def test_moe_refuses_uneven_shares_and_masks_over_data(ranks2):
    """Uneven batch shares (8, 0) and a ``loss_mask`` at data 2 raise
    ``ValueError`` for the moe family, saying why."""
    _, _, metas = ranks2
    for m in metas:
        assert "every replica in its all-reduce" in m["uneven_refused"]
        assert "loss_mask for the moe family" in m["mask_refused"]


def _fclose(got, want, msg=""):
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL.fwd, rtol=TOL.fwd, err_msg=msg)


@pytest.mark.parametrize("world", list(SERVE))
def test_serving_prefill_matches_reference(world, ref, request):
    """Logits gathered over the vocab split and the cache gathered over
    the kv heads, at gen budgets 0, 7 and 8; every rank holds E/model
    whole experts."""
    _, res, metas = request.getfixturevalue(f"ranks{world}")
    assert all(m["experts_local"] == 8 // SERVE[world][1] for m in metas)
    for gb in (0, *DENSE_GB.values()):
        logits, cache = ref["prefill", gb]
        _fclose(res[f"prefill{gb}/logits"], logits, f"gb {gb}")
        for k, v in cache.items():
            _fclose(res[f"prefill{gb}/{k}"], v, f"gb {gb} {k}")


@pytest.mark.parametrize("world", list(SERVE))
@pytest.mark.parametrize("name", list(DENSE_GB))
def test_serving_dense_steps_match_reference(name, world, ref, request):
    """Teacher-forced dense steps from the reference's prefill state, the
    cache's sequence split over model (24 rows) or its kv heads (23)."""
    _, res, metas = request.getfixturevalue(f"ranks{world}")
    _fclose(res[f"dense_{name}/logits"], ref["dense", DENSE_GB[name]])
    seq, heads = ("model", None) if name == "seq" else (None, "model")
    assert metas[0][f"dense_{name}_spec"] == [None, "data", seq, heads,
                                              None]


@pytest.mark.parametrize("world", list(SERVE))
def test_serving_paged_steps_match_reference(world, ref, request):
    """Teacher-forced paged steps on each rank's kv heads, three live
    slots in scattered pages and an inactive one."""
    _, res, _ = request.getfixturevalue(f"ranks{world}")
    _fclose(res["paged/logits"][:, :SB - 1], ref["paged"][:, :SB - 1])


@pytest.mark.parametrize("world", list(SERVE))
@pytest.mark.parametrize("name", list(SERVERS))
def test_server_tokens_match_reference(name, world, ref, request):
    """The Server over the mesh gives every request the reference
    Server's greedy tokens, on every rank."""
    _, _, metas = request.getfixturevalue(f"ranks{world}")
    for m in metas:
        assert m[f"server_{name}"] == ref["server", name]
