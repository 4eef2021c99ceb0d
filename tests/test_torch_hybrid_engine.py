"""The ssm and hybrid families across the port's engine against the
reference on the CPU: mamba2-1.3b and jamba-v0.1-52b in a pipeline,
jamba split over ``model`` with its experts (tp 2 = ep 2) and balanced
over the global batch at data 2 × model 2, and jamba served over
``model``.

The models are the reference's smoke configs in f32, remat none, their
weights drawn by the reference and carried across by
``params_from_numpy``: mamba2 at 2 and 3 layers (a period of 1), jamba at
its ``SMOKE`` (one period of 4) and at 4 layers of ``attn_period=2`` (two
periods, an SSD + dense block and an attention + experts block, one
period a stage); the batch is 4 × 64 seeded numpy tokens, two chunks of
32 a row.  Deeper random stacks are held in f64
(tests/test_torch_hybrid_depth.py): in f32 both packages' rounding grows
with depth past the gradient tolerance (ROADMAP.md §C).  Tolerances f32
(tests/torch_harness.py): values 2e-5, gradients 2e-4; serving logits
1e-4 and SSD states against token-by-token decode 2e-3, as the ssm
family's tests.

- The schedule interpreter ``schedule_grads`` at pp 2 against the
  reference's, gpipe and 1f1b: the loss, every gradient leaf (mamba2's
  tied table summed over its lookup on stage 0 and its head on stage 1)
  and jamba's ``moe_lb``/``moe_z`` against the reference's aux.
- A stage allocation that is not a whole number of periods, refused with
  the reference's message, at jamba's period of 8 and mamba2's of 1.
- One spawn of 2 gloo ranks: the multi-rank engine at pp 2 (mamba2 even
  and (2, 1), jamba even) against the reference's ``schedule_grads``;
  jamba at tp 2 = ep 2 against the reference's ``loss_fn``; jamba (2 kv
  heads) served at model 2: prefill logits, KV and SSD states, dense
  steps with the cache's sequence or its kv heads split, and the
  Server's tokens, against the reference's ``serve_step``.
- One spawn of 4 gloo ranks: jamba at pp 2 × model 2, and at data 2 ×
  model 2 with the experts balanced over the global batch, against the
  reference's ``schedule_grads`` and ``loss_fn`` on the whole batch.
- ``torchrun`` jobs of ``train --arch mamba2-1.3b --pp 2`` and ``train
  --arch jamba-v0.1-52b --mesh 1x2`` against the drivers' one-device
  losses.
- jamba's plans: ``auto_parallel`` and the search on the port's own
  ``model_graph``, and the hardware-aware placement of the reference's
  fig-10 workload (32 mixed cards, where the hand-even split does not
  fit), equal (``==``) to the reference's.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from jax.sharding import AbstractMesh

from repro.core import auto as ref_auto
from repro.core import cost_model as ref_cm
from repro.core import hetero as ref_het
from repro.core import planner as ref_planner
from repro.models import lm as ref_lm
from repro.optim import optimizer as jax_opt
from repro.models import transformer as jax_tfm
from repro_torch.configs import get_config
from repro_torch.core import auto, hetero, planner, sharding
from repro_torch.core import cost_model as cm
from repro_torch.core.cost_model import StrategySpec
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro_torch.serving.server import Request, Server
from repro_torch.tree import flatten, tree_map

from torch_harness import TOLS, data, outcome

ref_pipe = importlib.import_module("repro.core.pipeline")
pipe = importlib.import_module("repro_torch.core.pipeline")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = TOLS["float32"]
LOGIT_TOL = 1e-4
STATE_TOL = 2e-3
ARCHS = {"m2": "mamba2-1.3b", "jb": "jamba-v0.1-52b"}
B, T, M = 4, 64, 2
#: the models: key -> (arch, n_layers, overrides)
MODELS = {"m2_2": ("m2", 2, {}), "m2_3": ("m2", 3, {}),
          "jb_p2": ("jb", 4, {"attn_period": 2, "attn_offset": 1}),
          "jb_4": ("jb", 4, {}),
          "jb_kv2": ("jb", 4, {"n_kv_heads": 2})}
#: the interpreter's cases: (model, schedule, stage layers)
INTERP = [("m2_2", "gpipe", (1, 1)), ("m2_2", "1f1b", (1, 1)),
          ("m2_3", "1f1b", (2, 1)), ("jb_p2", "gpipe", (1, 1)),
          ("jb_p2", "1f1b", (1, 1))]
#: the engine's cases: name -> (world, model, schedule, stage layers,
#: model axis)
ENGINE = {"m2_pp2": (2, "m2_2", "1f1b", (1, 1), 1),
          "m2_pp2_21": (2, "m2_3", "1f1b", (2, 1), 1),
          "jb_pp2": (2, "jb_p2", "1f1b", (1, 1), 1),
          "jb_pp2_tp2": (4, "jb_p2", "1f1b", (1, 1), 2)}
#: the unpipelined split steps on jb_4: name -> (world, strategy)
SPLIT = {"jb_tp2": (2, StrategySpec(tp=2, ep=2)),
         "jb_dp2_tp2": (4, StrategySpec(dp=2, tp=2, ep=2))}
# serving at model 2 (jb_kv2)
SB, SS = 2, 32                    # slots and prompt length
LAST = [20, 31]
STEPS = 4
DENSE_GB = {"seq": 8, "heads": 7}
SPEC = [(9, 6), (30, 5), (17, 7)]   # Server requests: (prompt, new tokens)
SERVE_LEN = 64


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


def _cfgs(key: str):
    arch, layers, kw = MODELS[key]
    over = dict(n_layers=layers, **kw)
    return (dataclasses.replace(jax_get_config(ARCHS[arch], smoke=True),
                                **over),
            dataclasses.replace(get_config(ARCHS[arch], smoke=True), **over))


def _ref_aux(jm, params, tokens) -> tuple:
    """The reference's experts' aux over M micro-batches of ``tokens``:
    the mean of its ``loss_fn``'s ``moe_lb`` and ``moe_z``."""
    mets = [jm.loss_fn(params, {"tokens": jnp.asarray(t)})[1]
            for t in np.split(tokens, M)]
    return (float(np.mean([m["moe_lb"] for m in mets])),
            float(np.mean([m["moe_z"] for m in mets])))


def _token_by_token(jm, jp, step, tokens, cache_len):
    """The reference's exact route to a decode state: its ``serve_step``
    (``step``, jitted) over the columns of ``tokens`` (B, S) from a zero
    state.  → (last logits, state)."""
    state = {"cache": jax_tfm.init_stack_state(jm.stack, tokens.shape[0],
                                               cache_len, jm.cfg.adtype),
             "pos": jnp.zeros((tokens.shape[0],), jnp.int32)}
    for t in range(tokens.shape[1]):
        logits, state = step(jp, jnp.asarray(tokens[:, t], jnp.int32),
                             state)
    return logits, state


def _ref_serving(jm, jp, out: dict) -> None:
    """Prefill logits (ragged) and KV, the token-by-token states at every
    cache length, teacher-forced dense steps from them, and greedy tokens
    of a reference loop per request."""
    rng = np.random.default_rng(3)
    V = jm.cfg.vocab
    out["s_tokens"] = rng.integers(0, V, (SB, SS)).astype(np.int32)
    out["s_steps"] = rng.integers(0, V, (STEPS, SB)).astype(np.int32)
    out["prompts"] = [rng.integers(0, V, n) for n, _ in SPEC]
    logits, st = jm.prefill(jp, {"tokens": jnp.asarray(out["s_tokens"])},
                            gen_budget=8, last_idx=jnp.asarray(LAST))
    out["prefill"] = (np.asarray(logits), _np(st["cache"]["p2"]))
    step = jax.jit(jm.serve_step)
    for gb in DENSE_GB.values():
        logits, st = _token_by_token(jm, jp, step, out["s_tokens"],
                                     SS + gb)
        out["tbt", gb] = (np.asarray(logits), _np(st["cache"]))
        lg = []
        for t in range(STEPS):
            logits, st = step(jp, jnp.asarray(out["s_steps"][t]), st)
            lg.append(np.asarray(logits))
        out["dense", gb] = np.stack(lg)
    toks = {}
    for i, (prompt, (_, max_new)) in enumerate(zip(out["prompts"], SPEC)):
        logits, st = _token_by_token(jm, jp, step, prompt[None],
                                     SERVE_LEN)
        t = [int(jnp.argmax(logits[0, :V]))]
        while t[-1] != 1 and len(t) < max_new:
            logits, st = step(jp, jnp.asarray(t[-1:], jnp.int32), st)
            t.append(int(jnp.argmax(logits[0, :V])))
        toks[str(i)] = t
    out["server"] = toks


@pytest.fixture(scope="module")
def ref():
    """The reference on the same weights and tokens: its interpreter for
    every case (with jamba's aux), ``loss_fn`` on the whole batch for the
    split steps, and its unmeshed serving."""
    out = {"tokens": np.random.default_rng(0).integers(
        0, 512, (B, T)).astype(np.int32)}
    toks = out["tokens"]
    for i, key in enumerate(MODELS):
        jcfg, _ = _cfgs(key)
        jm = ref_lm.build(jcfg)
        jp = jax.jit(jm.init)(jax.random.key(i))
        out["params", key] = _np(jp)
        for _, sched, sl in (c for c in INTERP if c[0] == key):
            loss, g, _ = ref_pipe.schedule_grads(
                jm, jp, jnp.asarray(toks), micro_batches=M, schedule=sched,
                stage_layers=sl)
            aux = _ref_aux(jm, jp, toks) if jcfg.n_experts else None
            out[key, sched, sl] = (float(loss), _np(g), aux)
        if key == "jb_4":
            grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
            (loss, m), g = grad_fn(jp, {"tokens": jnp.asarray(toks)})
            out["whole"] = (float(loss), {k: float(v) for k, v in m.items()},
                            _np(g))
        if key == "jb_kv2":
            _ref_serving(jm, jp, out)
    return out


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=tol, rtol=tol,
                                   err_msg=f"{what} {path}")


def _fclose(got, want, tol=LOGIT_TOL, msg=""):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# the schedule interpreter, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,sched,sl", INTERP)
def test_interpreter_matches_reference(key, sched, sl, ref):
    _, cfg = _cfgs(key)
    model = Model(cfg, "cpu")
    params = params_from_numpy(cfg, ref["params", key], "cpu")
    loss, grads, stats = pipe.schedule_grads(
        model, params, torch.tensor(ref["tokens"]), micro_batches=M,
        schedule=sched, stage_layers=sl)
    want_loss, want_g, aux = ref[key, sched, sl]
    np.testing.assert_allclose(float(loss), want_loss, atol=TOL.fwd,
                               rtol=TOL.fwd)
    if aux is None:
        assert "moe_lb" not in stats and "head" not in grads
    else:
        for k, v in zip(("moe_lb", "moe_z"), aux):
            np.testing.assert_allclose(float(stats[k]), v, atol=TOL.fwd,
                                       rtol=TOL.fwd, err_msg=k)
        assert float(stats["moe_lb"]) > 0
    _close({p: v.numpy() for p, v in zip(*flatten(grads))}, want_g,
           TOL.grad, f"{key} {sched} {sl}")


def test_tied_table_gradient_sums_both_ends(ref):
    """mamba2's table gradient in a pipeline is stage 0's lookup plus the
    last stage's head: without the head's part it misses the reference."""
    _, cfg = _cfgs("m2_2")
    model = Model(cfg, "cpu")
    params = params_from_numpy(cfg, ref["params", "m2_2"], "cpu")
    want = ref["m2_2", "1f1b", (1, 1)][1]["embed/table"]
    real = model.head_loss

    def cut(p, x, tokens, mask):        # the head reads a detached table
        return real(dict(p, embed={"table": p["embed"]["table"].detach()}),
                    x, tokens, mask)

    model.head_loss = cut
    _, grads, _ = pipe.schedule_grads(
        model, params, torch.tensor(ref["tokens"]), micro_batches=M,
        schedule="1f1b", stage_layers=(1, 1))
    gap = np.abs(grads["embed"]["table"].numpy() - want)
    assert (gap > TOL.grad * (1 + np.abs(want))).any()


@pytest.mark.parametrize("arch,alloc", [
    ("jamba-v0.1-52b", (12, 20)), ("jamba-v0.1-52b", (16, 16)),
    ("jamba-v0.1-52b", (8, 8, 8, 8)), ("jamba-v0.1-52b", (4, 28)),
    ("jamba-v0.1-52b", (8, 16)), ("mamba2-1.3b", (20, 28)),
    ("mamba2-1.3b", (47, 1)), ("mamba2-1.3b", (20, 20))])
def test_misaligned_stage_allocation_refused_as_reference(arch, alloc):
    """A stage's share must be whole periods (jamba's 8 blocks, mamba2's
    1): the port's ``stage_layers_from_alloc`` and the plan's
    ``--stage-layers`` check give the reference's result or message."""
    ours = lm.build_stack_cfg(get_config(arch))
    want = ref_lm.build_stack_cfg(jax_get_config(arch))
    assert outcome(pipe.stage_layers_from_alloc, ours, alloc) == \
        outcome(ref_pipe.stage_layers_from_alloc, want, alloc)
    assert outcome(pipe.check_stage_layers, alloc, ours.n_rep, len(alloc)) \
        == outcome(ref_pipe.check_stage_layers, alloc, want.n_rep,
                   len(alloc))


# ---------------------------------------------------------------------------
# jamba's layouts against the reference's (==)
# ---------------------------------------------------------------------------

def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("model_axis", [1, 2, 4])
def test_staged_specs_of_the_mixed_period_equal_reference(model_axis):
    """jamba at full size, stage 2 × model 1, 2 or 4, a period a stage
    (2, 2): the parameter and AdamW specs of both mixers, the experts and
    the dense MLPs are the reference's ``staged_specs``."""
    sizes, axes = (2, 1, model_axis), ("stage", "data", "model")
    kw = dict(tp=model_axis, pp=2, ep=model_axis)
    jm = ref_lm.build(jax_get_config("jamba-v0.1-52b"))
    rplan = ref_planner.compile_plan(jm, AbstractMesh(sizes, axes),
                                     ref_cm.StrategySpec(**kw))
    pshapes = ref_pipe._padded_model_shapes(jm, (2, 2))
    want = ref_pipe.staged_specs(rplan.rules, jm.axes(), pshapes)
    opt = jax_opt.adamw()
    want_opt = ref_pipe.staged_specs(rplan.rules, opt.state_axes(jm.axes()),
                                     jax.eval_shape(opt.init, pshapes))
    strat = StrategySpec(**kw)
    plan = planner.ExecutionPlan(
        model=Model(get_config("jamba-v0.1-52b"), "meta"), mesh=None,
        strategy=strat,
        rules=sharding.rules_for_strategy(dict(zip(axes, sizes)), strat))
    assert _specs(plan.param_specs) == _specs(want)
    assert _specs(plan.state_layout(adamw())) == _specs(want_opt)
    blocks = plan.param_specs["blocks"]
    if model_axis > 1:
        assert blocks["p4"]["attn"]["wq"][0] == "stage"
        assert "model" in blocks["p0"]["ssd"]["A_log"]
        assert blocks["p1"]["moe"]["w_in"] == ("stage", "model", None, None)


@pytest.mark.parametrize("shape,zero", [((1, 2), 0), ((2, 2), 0),
                                        ((2, 2), 3)])
def test_param_specs_of_the_mixed_period_equal_reference(shape, zero):
    """jamba at full size at data × model, ZeRO 0 or 3 (the specs
    ``fsdp_specs`` gathers by, over a pattern with both mixers): every
    leaf's spec with ``==``."""
    axes = ("data", "model")
    kw = dict(dp=shape[0], tp=shape[1], ep=shape[1], zero=zero,
              vocab_split=True)
    jm = ref_lm.build(jax_get_config("jamba-v0.1-52b"))
    ref = ref_planner.compile_plan(jm, AbstractMesh(shape, axes),
                                   ref_cm.StrategySpec(**kw))
    strat = StrategySpec(**kw)
    ours = planner.ExecutionPlan(
        model=Model(get_config("jamba-v0.1-52b"), "meta"), mesh=None,
        strategy=strat,
        rules=sharding.rules_for_strategy(dict(zip(axes, shape)), strat))
    assert _specs(ours.param_specs) == _specs(ref.param_specs)
    if zero:
        assert "data" in ours.param_specs["blocks"]["p1"]["moe"]["w_in"]


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------

def _spy(opt, seen: dict):
    real_apply = opt.apply

    def apply(grads, state, p, step, **kw):
        seen["grads"] = tree_map(torch.clone, grads)
        return real_apply(grads, state, p, step, **kw)

    return dataclasses.replace(opt, apply=apply)


def _full(d: dict, key: str, cfg) -> dict:
    return params_from_numpy(cfg, {k.split("/", 1)[1]: v for k, v in
                                   d.items() if k.startswith(f"{key}/")},
                             "cpu")


def _engine_case(name: str, d: dict, res: dict, meta: dict) -> None:
    _, key, sched, sl, mp = ENGINE[name]
    _, cfg = _cfgs(key)
    model = Model(cfg, "cpu")
    strat = StrategySpec(tp=mp, ep=mp if cfg.has_experts else 1, pp=2,
                         micro_batches=M, schedule=sched)
    plan = planner.compile_plan(
        model, planner.mesh_for_strategy(strat, device_type="cpu"), strat)
    stage = plan.mesh.get_local_rank("stage")
    params = plan.shard(pipe.stage_state(_full(d, key, cfg), stage, sl),
                        sharding.within_stage(plan.param_specs))
    seen = {}
    opt = _spy(adamw(lr=1e-3), seen)
    step = plan.pipeline_train_step_fn(opt, stage_layers=sl)
    _, _, m = step(params, opt.init(params), torch.tensor(d["tokens"]), 0)
    meta[name] = {k: float(m[k]) for k in ("loss", "moe_lb", "moe_z")}
    grads = pipe.gather_stages(seen["grads"], plan.param_specs, plan.rules,
                               sl)
    if dist.get_rank() == 0:
        grads = dict(grads, blocks=pipe.unpad_stage_stack(grads["blocks"],
                                                          sl))
        for path, v in zip(*flatten(grads)):
            res[f"{name}/{path}"] = v.numpy()


def _split_case(name: str, d: dict, res: dict, meta: dict) -> None:
    _, strat = SPLIT[name]
    _, cfg = _cfgs("jb_4")
    model = Model(cfg, "cpu")
    plan = planner.compile_plan(
        model, planner.mesh_for_strategy(strat, device_type="cpu"), strat)
    params = plan.shard(_full(d, "jb_4", cfg), plan.param_specs)
    meta[f"{name}_experts_local"] = int(
        params["blocks"]["p1"]["moe"]["w_in"].shape[1])
    meta[f"{name}_ssd_heads_local"] = int(
        params["blocks"]["p0"]["ssd"]["A_log"].shape[-1])
    seen = {}
    opt = _spy(adamw(lr=1e-3), seen)
    step = plan.train_step_fn(opt)
    batch = plan.batch_slice({"tokens": torch.tensor(d["tokens"])})
    _, _, m = step(params, plan.init_opt(opt, params), batch, 0)
    meta[name] = {k: float(m[k]) for k in ("loss", "moe_lb", "moe_z")}
    meta[f"{name}_line"] = plan.split_line()
    grads = tree_map(lambda g, s: sharding.gather_leaf(g, s, plan.rules),
                     seen["grads"], plan.param_specs)
    if dist.get_rank() == 0:
        for path, v in zip(*flatten(grads)):
            res[f"{name}/{path}"] = v.numpy()


def _serve_case(d: dict, res: dict, meta: dict) -> None:
    _, cfg = _cfgs("jb_kv2")
    model = Model(cfg, "cpu")
    plan = planner.compile_plan(model, make_mesh((1, 2), ("data", "model"),
                                                 device_type="cpu"))
    params = model.serving_params(plan.shard(_full(d, "jb_kv2", cfg),
                                             plan.param_specs))
    group = plan.rules.group("model")
    logits, st = plan.prefill_fn(8)(
        params, {"tokens": torch.tensor(d["s_tokens"])},
        last_idx=torch.tensor(LAST))
    res["prefill/logits"] = logits.numpy()
    for k in ("k", "v"):                  # (L, B, S, K, D): kv heads dim 3
        res[f"prefill/{k}"] = sharding.gather_cat(
            st["cache"]["p2"][k], group, 3).numpy()
    _, st = plan.prefill_fn(0)(params,
                               {"tokens": torch.tensor(d["s_tokens"])})
    for i in (0, 1, 3):                   # (L, B, [d_conv-1,] H, P[, N])
        res[f"state/p{i}/h"] = sharding.gather_cat(
            st["cache"][f"p{i}"]["h"], group, 2).numpy()
        res[f"state/p{i}/conv"] = sharding.gather_cat(
            st["cache"][f"p{i}"]["conv"], group, 3).numpy()
    steps = torch.tensor(d["s_steps"]).long()
    for name, gb in DENSE_GB.items():
        specs = plan.state_specs(SB, SS + gb)
        whole = {"cache": {p: {k: torch.tensor(d[f"tbt{gb}/{p}/{k}"])
                               for k in c}
                           for p, c in specs["cache"].items()},
                 "pos": torch.full((SB,), SS, dtype=torch.int32)}
        state = tree_map(lambda x, s: sharding.shard_leaf(x, s, plan.rules),
                         whole, specs)
        meta[f"dense_{name}_spec"] = list(specs["cache"]["p2"]["k"])
        meta[f"dense_{name}_h_spec"] = list(specs["cache"]["p0"]["h"])
        step = plan.serve_step_fn(SB, SS + gb)
        lg = []
        for t in range(STEPS):
            logits, state = step(params, steps[t], state)
            lg.append(plan.gather_slots(logits))
        res[f"dense_{name}/logits"] = torch.stack(lg).numpy()
    prompts = [d[f"prompt{i}"] for i in range(len(SPEC))]
    server = Server(model, plan, batch_slots=SB, max_len=SERVE_LEN,
                    cache="dense")
    pending = [Request(i, p.astype(np.int32), max_new=g)
               for i, (p, (_, g)) in enumerate(zip(prompts, SPEC))]
    done = []
    for _ in range(200):
        if not (pending or server.active):
            break
        while pending and (slot := server.free_slot()) is not None:
            req = pending.pop(0)
            server.admit(params, req, slot)
            if req.done:
                done.append(req)
        done.extend(server.step(params))
    meta["server"] = {str(r.rid): [int(t) for t in r.out_tokens]
                      for r in done}


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    d = dict(np.load(inputs))
    res, meta = {}, {}
    for name, case in ENGINE.items():
        if case[0] == world:
            _engine_case(name, d, res, meta)
    for name, (w, _) in SPLIT.items():
        if w == world:
            _split_case(name, d, res, meta)
    if world == 2:
        _serve_case(d, res, meta)
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _spawn(world: int, ref, tmp_path_factory) -> tuple:
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp(f"hybrid_engine{world}")
    arrays = {"tokens": ref["tokens"], "s_tokens": ref["s_tokens"],
              "s_steps": ref["s_steps"],
              **{f"{key}/{k}": v for key in MODELS
                 for k, v in ref["params", key].items()},
              **{f"prompt{i}": p for i, p in enumerate(ref["prompts"])}}
    for gb in DENSE_GB.values():
        for k, v in ref["tbt", gb][1].items():
            arrays[f"tbt{gb}/{k}"] = v
    np.savez(d / "inputs.npz", **arrays)
    ctx = mp.start_processes(
        _rank_main, args=(world, str(d / "store"), str(d / "inputs.npz"),
                          str(d)), nprocs=world, join=False,
        start_method="spawn")
    for p in ctx.processes:
        p.join(300)
    alive = [p for p in ctx.processes if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank did not finish within 300 s"
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
    """Loss (and jamba's ``moe_lb``, ``moe_z``) on every rank and the
    gathered gradient against the reference's ``schedule_grads``;
    mamba2's tied table summed over the two stages."""
    w, key, sched, sl, _ = ENGINE[name]
    _, res, metas = request.getfixturevalue(f"ranks{w}")
    want_loss, want_g, aux = ref[key, sched, sl]
    for m in metas:
        got = m[name]
        np.testing.assert_allclose(got["loss"], want_loss, atol=TOL.fwd,
                                   rtol=TOL.fwd)
        for k, v in zip(("moe_lb", "moe_z"), aux or (0.0, 0.0)):
            np.testing.assert_allclose(got[k], v, atol=TOL.fwd,
                                       rtol=TOL.fwd, err_msg=k)
    _close(_grads(res, name), want_g, TOL.grad, name)


@pytest.mark.parametrize("name", list(SPLIT))
def test_split_experts_match_reference_whole_batch(name, ref, request):
    """tp 2 = ep 2 (4 of the 8 experts, 4 of the 8 SSD heads a rank), and
    data 2 × model 2 with the experts balanced over the global batch: the
    loss, aux and every gradient leaf against the reference's ``loss_fn``
    on the whole batch; the ``[plan]`` line names what the split
    splits."""
    _, res, metas = request.getfixturevalue(f"ranks{SPLIT[name][0]}")
    want_loss, want_m, want_g = ref["whole"]
    for m in metas:
        np.testing.assert_allclose(m[name]["loss"], want_loss, atol=TOL.fwd,
                                   rtol=TOL.fwd)
        for k in ("moe_lb", "moe_z"):
            np.testing.assert_allclose(m[name][k], want_m[k], atol=TOL.fwd,
                                       rtol=TOL.fwd, err_msg=k)
        assert m[f"{name}_experts_local"] == 4
        assert m[f"{name}_ssd_heads_local"] == 4
        assert "split×2 over model (heads, SSD heads, whole experts, MLP " \
            "columns, vocab)" in m[f"{name}_line"]
    _close(_grads(res, name), want_g, TOL.grad, name)


def test_serving_prefill_over_model_matches_reference(ranks2, ref):
    """Prefill logits (gathered over the vocab split) and the attention
    block's KV (over its kv heads) against the reference's prefill; the
    SSD blocks' states (over their heads) against the reference's
    ``serve_step`` token by token."""
    _, res, _ = ranks2
    logits, kv = ref["prefill"]
    _fclose(res["prefill/logits"], logits)
    for k in ("k", "v"):
        _fclose(res[f"prefill/{k}"], kv[k], msg=k)
    gb = DENSE_GB["seq"]
    state = ref["tbt", gb][1]
    for i in (0, 1, 3):
        for k in ("h", "conv"):
            _fclose(res[f"state/p{i}/{k}"], state[f"p{i}/{k}"], STATE_TOL,
                    f"p{i} {k}")


@pytest.mark.parametrize("name", list(DENSE_GB))
def test_serving_dense_steps_over_model_match_reference(name, ranks2, ref):
    """Teacher-forced steps from the reference's token-by-token state, the
    KV cache's sequence (40 rows) or its kv heads (39) split over model,
    the SSD states over their heads."""
    _, res, metas = ranks2
    _fclose(res[f"dense_{name}/logits"], ref["dense", DENSE_GB[name]])
    seq, heads = ("model", None) if name == "seq" else (None, "model")
    assert metas[0][f"dense_{name}_spec"] == [None, "data", seq, heads,
                                              None]
    assert metas[0][f"dense_{name}_h_spec"] == [None, "data", "model", None,
                                                None]


def test_server_over_model_matches_reference_loop(ranks2, ref):
    """The Server over model 2 gives every request the greedy tokens of a
    reference loop of ``serve_step``, on every rank."""
    _, _, metas = ranks2
    for m in metas:
        assert m["server"] == ref["server"]


# ---------------------------------------------------------------------------
# the drivers under torchrun (2 gloo ranks)
# ---------------------------------------------------------------------------

def _torchrun(module: str, argv: list, cwd) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", module] + argv,
        capture_output=True, text=True, timeout=300, env=env, cwd=str(cwd))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    return p.stdout


def _printed_losses(out: str) -> list:
    return [float(line.split()[3]) for line in out.splitlines()
            if line.strip().startswith("step ")]


def test_train_driver_pipelines_mamba2(tmp_path):
    """``train --arch mamba2-1.3b --pp 2`` (1f1b, 2 micro-batches) prints
    the losses of the run on one device (to the 4 decimals it prints)."""
    argv = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "64", "--log-every",
            "1"]
    one = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])["losses"]
    out = _torchrun("repro_torch.launch.train", argv + [
        "--pp", "2", "--schedule", "1f1b", "--micro-batches", "2",
        "--ckpt-dir", str(tmp_path / "pp")], tmp_path)
    assert "stage_layers (1, 1)" in out
    np.testing.assert_allclose(_printed_losses(out), one,
                               atol=TOL.grad + 5e-5, rtol=0)


def test_train_driver_splits_jamba_over_model(tmp_path):
    """``train --arch jamba-v0.1-52b --mesh 1x2`` prints the losses of the
    run on one device, and its ``[plan]`` line what the split splits."""
    argv = ["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "64", "--log-every",
            "1"]
    one = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])["losses"]
    out = _torchrun("repro_torch.launch.train", argv + [
        "--mesh", "1x2", "--ckpt-dir", str(tmp_path / "tp")], tmp_path)
    assert "split×2 over model (heads, SSD heads, whole experts, MLP " \
        "columns" in out
    np.testing.assert_allclose(_printed_losses(out), one,
                               atol=TOL.grad + 5e-5, rtol=0)


# ---------------------------------------------------------------------------
# jamba's plans against the reference's (==)
# ---------------------------------------------------------------------------

def _graph_pair(batch: int, seq: int):
    return (lm.model_graph(get_config("jamba-v0.1-52b"), batch, seq),
            ref_lm.model_graph(jax_get_config("jamba-v0.1-52b"), batch, seq))


@pytest.mark.parametrize("table", ("V100_PAPER", "H100_SXM"))
def test_auto_parallel_plans_jamba_as_reference(table):
    """On the port's own ``model_graph``: the chosen strategy (or the same
    "no feasible strategy" error) at 1, 8, 32 and 64 devices, and the
    top-5 frontier at 32."""
    hw = getattr(cm, table)             # the reference has no H100 table:
    ref_hw = ref_cm.Hardware(**{f.name: getattr(hw, f.name)   # carry it
                                for f in dataclasses.fields(hw)})
    g, rg = _graph_pair(64, 1024)
    for n in (1, 8, 32, 64):
        assert outcome(auto.auto_parallel, g, n, hw) == \
            outcome(ref_auto.auto_parallel, rg, n, ref_hw)
    assert data(auto.search(g, 32, hw, top_k=5)) == \
        data(ref_auto.search(rg, 32, ref_hw, top_k=5))


def _mixed_32(mod):
    return mod.ClusterSpec(groups=(
        mod.DeviceGroup("v100", mod.V100_PAPER, 16),
        mod.DeviceGroup("t4", mod.T4_16G, 16)))


def test_hardware_aware_placement_of_jamba_equals_reference():
    """The reference's fig-10 workload (batch 64 × 1024 on 16 V100s + 16
    T4s): the hand strategy's even split does not fit (inf), its balanced
    placement and the segment-aware search's feasible plan equal the
    reference's."""
    g, rg = _graph_pair(64, 1024)
    spec, rspec = _mixed_32(cm), _mixed_32(ref_cm)
    kw = dict(dp=4, pp=8, micro_batches=16)
    hand, rhand = cm.StrategySpec(**kw), ref_cm.StrategySpec(**kw)
    even = hetero.plan_placement(g, hand, spec, overlap=0.5, balanced=False)
    assert even.step_time == float("inf")
    assert data(even) == data(ref_het.plan_placement(
        rg, rhand, rspec, overlap=0.5, balanced=False))
    assert data(hetero.plan_placement(g, hand, spec, overlap=0.5)) == \
        data(ref_het.plan_placement(rg, rhand, rspec, overlap=0.5))
    got = auto.search(g, spec, top_k=1, overlap=0.5)
    want = ref_auto.search(rg, rspec, top_k=1, overlap=0.5)
    assert len(got) == len(want) == 1 and got[0].total != float("inf")
    assert data(got) == data(want)
    assert got[0].placement.describe() == want[0].placement.describe()
