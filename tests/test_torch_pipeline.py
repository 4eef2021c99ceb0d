"""The port's pipeline engine (``repro_torch.core.pipeline``) against the
reference (``repro.core.pipeline``) on the CPU: the layout helpers bit for
bit and message for message, the schedule interpreter ``schedule_grads``
against the reference's interpreter and ``jax.value_and_grad`` of the
unpipelined ``Model.loss_fn``, and the multi-rank engine on 2 and 4 gloo
ranks (``torch.multiprocessing.spawn`` over a ``FileStore`` in
``tmp_path``, one spawn per world size), gathered, against the reference's
interpreter, with one AdamW step against the reference optimizer's.

The reference's fused engine does not run on this jax
(tests/test_distributed.py::test_gpipe_loss_matches_reference), so its
order-faithful interpreter, whose own tests pass here
(tests/test_schedule.py), is the reference for every schedule, beside the
unpipelined loss and gradients.  The model is the smoke tinyllama at 4
layers in f32 (remat none), batch 8 × 16, weights drawn by the reference;
tolerances f32: values 2e-5, gradients 2e-4 (tests/torch_harness.py).
"""
import dataclasses
import importlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.core import schedule as ref_sch
from repro.models import lm as jax_lm
from repro.optim import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.core.cost_model import StrategySpec
from repro_torch.core.schedule import make_schedule
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro_torch.tree import flatten, unflatten

from torch_harness import TOLS, outcome

# ``repro.core`` exports the ``pipeline`` scope under the module's name
ref_pipe = importlib.import_module("repro.core.pipeline")
# … and so does ``repro_torch.core``
pipe = importlib.import_module("repro_torch.core.pipeline")

ARCH = "tinyllama-1.1b"
TOL = TOLS["float32"]
LR = 1e-3
B, T, M = 8, 16, 4
CASES = [(sched, sl) for sched in ("gpipe", "1f1b")
         for sl in ((2, 2), (3, 1), (1, 3))]


def _np(tree) -> dict:
    """A JAX tree → {leaf path: numpy}."""
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


def _pt(tree) -> dict:
    """A port tree → {leaf path: numpy}."""
    paths, leaves = flatten(tree)
    return {p: x.detach().numpy() for p, x in zip(paths, leaves)}


def _cfgs(tied: bool):
    kw = dict(n_layers=4, tie_embeddings=tied)
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=tol, rtol=tol,
                                   err_msg=f"{what} {path}")


@pytest.fixture(scope="module")
def ref():
    """The reference on the same weights and tokens: the unpipelined
    loss and gradients, its interpreter for every case, at 4 stages, and
    a tied-embedding model's."""
    out = {"tokens": np.random.default_rng(0).integers(
        0, 512, (B, T)).astype(np.int32)}
    toks = jnp.asarray(out["tokens"])
    for tied in (False, True):
        jcfg, _ = _cfgs(tied)
        jm = jax_lm.build(jcfg)
        params = jm.init(jax.random.key(int(tied)))
        runs = {"params": _np(params)}

        def interp(sched, sl, jm=jm, params=params):
            loss, grads, stats = ref_pipe.schedule_grads(
                jm, params, toks, micro_batches=M, schedule=sched,
                stage_layers=sl)
            return float(loss), _np(grads), stats

        if tied:
            runs["1f1b", (2, 2)] = interp("1f1b", (2, 2))
        else:
            (loss, _), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
                params, {"tokens": toks})
            runs["plain"] = (float(loss), _np(grads))
            for sched, sl in CASES + [("1f1b", (1, 1, 1, 1))]:
                runs[sched, sl] = interp(sched, sl)
        out[tied] = runs
    return out


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sl", [(3, 1), (1, 3), (2, 2), (1, 2, 1)])
def test_padded_layout_matches_reference_bit_for_bit(sl, ref):
    want_params = ref[False]["params"]
    _, cfg = _cfgs(False)
    params = params_from_numpy(cfg, want_params, "cpu")
    jparams = unflatten(list(want_params), [jnp.asarray(v) for v in
                                            want_params.values()])
    want = _np(ref_pipe.pipeline_params(None, jparams, sl))
    got = _pt(pipe.pipeline_params(None, params, sl))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    back = _pt(pipe.unpad_stage_stack(pipe.pad_stage_stack(
        params["blocks"], sl), sl))
    for path, v in back.items():
        np.testing.assert_array_equal(v, want_params[f"blocks/{path}"])
    # pad rows are zero; an even split is the identity
    lmax = max(sl)
    for v in pipe.pad_stage_stack(params["blocks"], sl).values():
        for leaf in flatten(v)[1]:
            for s, n in enumerate(sl):
                assert not leaf[s * lmax + n:(s + 1) * lmax].any()
    if len(set(sl)) == 1:
        assert pipe.pad_stage_stack(params["blocks"], sl) is params["blocks"]


STACK = types.SimpleNamespace(pattern=(0,), n_rep=8)
STACK2 = types.SimpleNamespace(pattern=(0, 0), n_rep=4)
HELPER_CASES = [
    ("even_stage_layers", (8, 4)), ("even_stage_layers", (8, 3)),
    ("check_stage_layers", ((3, 3, 1, 1), 8, 4)),
    ("check_stage_layers", ((3, 3), 8, 2)),
    ("check_stage_layers", ((8, 0), 8, 2)),
    ("check_stage_layers", ((4, 4), 8, 3)),
    ("stage_layers_from_alloc", (STACK, (3, 3, 1, 1))),
    ("stage_layers_from_alloc", (STACK, (3, 3, 1))),
    ("stage_layers_from_alloc", (STACK2, (4, 2, 2))),
    ("stage_layers_from_alloc", (STACK2, (4, 3, 1))),
    ("check_micro_divides", (8, 4)), ("check_micro_divides", (8, 3)),
    ("check_micro_divides", (8, 0)),
]


@pytest.mark.parametrize("name,args", HELPER_CASES,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(HELPER_CASES)])
def test_helpers_match_reference_message_for_message(name, args):
    assert outcome(getattr(pipe, name), *args) == \
        outcome(getattr(ref_pipe, name), *args)


def test_planner_uses_the_pipeline_guard():
    """``accumulate`` raises the reference's message for a ragged split."""
    _, cfg = _cfgs(False)
    model = Model(cfg, "cpu")
    with pytest.raises(ValueError, match="silently drop 2 sequence"):
        planner.accumulate(model, model.init(0),
                           {"tokens": torch.zeros((8, 4), dtype=torch.long)},
                           3)


# ---------------------------------------------------------------------------
# the schedule interpreter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched,sl", CASES)
def test_interpreter_matches_reference_interpreter_and_plain_grads(
        sched, sl, ref):
    r = ref[False]
    _, cfg = _cfgs(False)
    model = Model(cfg, "cpu")
    params = params_from_numpy(cfg, r["params"], "cpu")
    loss, grads, stats = pipe.schedule_grads(
        model, params, torch.tensor(ref["tokens"]), micro_batches=M,
        schedule=sched, stage_layers=sl)
    want_loss, want_grads, want_stats = r[sched, sl]
    assert stats == want_stats
    assert stats["per_stage_in_flight"] == \
        make_schedule(sched, 2, M).per_stage_in_flight()
    got = _pt(grads)
    assert all(v.dtype == np.float32 for v in got.values())
    for what, (wl, wg) in (("interpreter", (want_loss, want_grads)),
                           ("plain", r["plain"])):
        np.testing.assert_allclose(float(loss), wl, atol=TOL.fwd,
                                   rtol=TOL.fwd, err_msg=what)
        _close(got, wg, TOL.grad, what)
    # the caller's parameters carry no autograd state afterwards
    assert all(not p.requires_grad and p.grad is None
               for p in flatten(params)[1])


def test_stage_adds_each_gradient_as_the_backward_computes_it():
    """A stage of 4 repeats: when the backward reaches a leaf of the last
    repeat, its gradient is already in the stage's stacked gradient while
    the first repeat's row is still zero; the first repeat's follows.  No
    leaf waits for the slot's end, where every raw gradient of the slot
    would be held at once."""
    _, cfg = _cfgs(False)
    model = Model(cfg, "cpu")
    params = model.init(0)
    n = model.stack.n_rep
    shared = pipe._leaves({k: params[k]
                           for k in pipe._shared_keys(model)})
    stage = pipe._Stage(model, 0, 1, params["blocks"], shared, n, 1, 2, T)
    path = "p0/attn/wq"
    rows = dict(zip(*flatten(stage.grads)))[path]
    seen = []
    dict(zip(*flatten(stage.reps[-1])))[path] \
        .register_post_accumulate_grad_hook(
            lambda leaf: seen.append((bool(rows[-1].abs().sum() > 0),
                                      bool((rows[0] == 0).all()))))
    toks = torch.randint(0, cfg.vocab, (2, T),
                         generator=torch.Generator().manual_seed(0))
    stage.forward(0, None, toks)
    stage.backward(0, None)
    assert n == 4 and seen == [(True, True)]
    assert bool(rows[0].abs().sum() > 0)
    assert stage.block_grads()["p0"]["attn"]["wq"].data_ptr() \
        == rows.data_ptr()


def test_interpreter_audit_and_guards(ref):
    _, cfg = _cfgs(False)
    model = Model(cfg, "cpu")
    params = params_from_numpy(cfg, ref[False]["params"], "cpu")
    toks = torch.tensor(ref["tokens"])
    # a built Schedule passes through; its micro-batches must agree
    sc = make_schedule("1f1b", 4, M)
    _, _, stats = pipe.schedule_grads(model, params, toks, micro_batches=M,
                                      schedule=sc)
    assert stats["per_stage_in_flight"] == [4, 3, 2, 1]
    assert stats["n_ticks"] == sc.n_ticks == \
        ref_sch.make_schedule("1f1b", 4, M).n_ticks
    with pytest.raises(ValueError, match="n_micro=4"):
        pipe.schedule_grads(model, params, toks, micro_batches=2,
                            schedule=sc)
    with pytest.raises(ValueError, match="micro_batches"):
        pipe.schedule_grads(model, params, toks[:7], micro_batches=M,
                            schedule="1f1b", n_stages=2)
    with pytest.raises(ValueError, match="sums to"):
        pipe.schedule_grads(model, params, toks, micro_batches=M,
                            stage_layers=(3, 3))
    # the decoder families pipeline (the ssm and hybrid ones:
    # tests/test_torch_hybrid_engine.py); an encoder-decoder has no layer
    # stack and pipelines over the two-tower engine
    # (tests/test_torch_multimodal.py), so the interpreter refuses it as
    # the reference's does
    encdec = types.SimpleNamespace(
        cfg=dataclasses.replace(cfg, family="encdec"), stack=None)
    with pytest.raises(ValueError, match="two-tower"):
        pipe.schedule_grads(encdec, {}, toks, micro_batches=M, n_stages=2)
    # the audit: a stage that keeps one graph too many is caught
    real = pipe._Stage.backward

    def leaky(self, mb, dy):
        out = real(self, mb, dy)
        self.peak += self.s == 0
        return out

    pipe._Stage.backward = leaky
    try:
        with pytest.raises(AssertionError, match="buffer audit"):
            pipe.schedule_grads(model, params, toks, micro_batches=M,
                                schedule="1f1b", n_stages=2)
    finally:
        pipe._Stage.backward = real


# ---------------------------------------------------------------------------
# the multi-rank engine on gloo ranks (one spawn per world size)
# ---------------------------------------------------------------------------

#: name: (pp, dp, schedule, stage_layers, tied, micro-batches per replica)
ENGINE = {2: {"gpipe_even": (2, 1, "gpipe", (2, 2), False, 4),
              "1f1b_31": (2, 1, "1f1b", (3, 1), False, 4),
              "1f1b_tied": (2, 1, "1f1b", (2, 2), True, 4)},
          4: {"pp4_1f1b": (4, 1, "1f1b", (1, 1, 1, 1), False, 4),
              "pp2_dp2_1f1b_13": (2, 2, "1f1b", (1, 3), False, 2)}}


def _engine_main(rank: int, world: int, store: str, inputs: str,
                 out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    data = dict(np.load(inputs))
    tokens = torch.tensor(data["tokens"])
    res, meta = {}, {}
    for name, (pp, dp, sched, sl, tied, mbs) in ENGINE[world].items():
        _, cfg = _cfgs(tied)
        model = Model(cfg, "cpu")
        strat = StrategySpec(dp=dp, pp=pp, micro_batches=mbs,
                             schedule=sched)
        mesh = planner.mesh_for_strategy(strat, device_type="cpu")
        plan = planner.compile_plan(model, mesh, strat)
        stage = mesh.get_local_rank("stage")
        params = params_from_numpy(
            cfg, {k[len(f"{tied}/"):]: v for k, v in data.items()
                  if k.startswith(f"{tied}/")}, "cpu")
        local = pipe.stage_state(params, stage, sl)
        seen = {}
        opt = adamw(lr=LR)
        real_apply = opt.apply

        def apply(grads, state, p, step, *, grad_norm=None,
                  real_apply=real_apply, **kw):
            seen["grads"] = {k: v.clone() for k, v in zip(*flatten(grads))}
            seen["norm"] = float(grad_norm)
            return real_apply(grads, state, p, step, grad_norm=grad_norm,
                              **kw)

        opt = dataclasses.replace(opt, apply=apply)
        step = plan.pipeline_train_step_fn(opt, stage_layers=sl)
        toks = plan.batch_slice({"tokens": tokens})["tokens"]
        p, _, metrics = step(local, opt.init(local), toks, 0)
        meta[name] = {"stage": stage, "data": mesh.get_local_rank("data"),
                      "loss": float(metrics["loss"]),
                      "peak": metrics["peak_in_flight"],
                      "norm": seen["norm"]}
        for path, v in seen["grads"].items():
            res[f"{name}/grads/{path}"] = v.numpy()
        for path, v in zip(*flatten(p)):
            res[f"{name}/params/{path}"] = v.numpy()
    if world == 2:
        # init_pipeline_params: the whole model drawn, then this stage's rows
        _, cfg = _cfgs(False)
        strat = StrategySpec(pp=2)
        mesh = planner.mesh_for_strategy(strat, device_type="cpu")
        plan = planner.compile_plan(Model(cfg, "cpu"), mesh, strat)
        for path, v in zip(*flatten(plan.init_pipeline_params(
                0, stage_layers=(3, 1)))):
            res[f"init/{path}"] = v.numpy()
        try:
            plan.pipeline_train_step_fn(adamw(), stage_layers=(2, 1))
        except ValueError as e:
            meta["bad_layers"] = str(e)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _spawn(world: int, ref, tmp_path_factory) -> list:
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp(f"engine{world}")
    inputs = {"tokens": ref["tokens"]}
    for tied in (False, True):
        inputs.update({f"{tied}/{k}": v
                       for k, v in ref[tied]["params"].items()})
    np.savez(d / "inputs.npz", **inputs)
    ctx = mp.start_processes(
        _engine_main, args=(world, str(d / "store"), str(d / "inputs.npz"),
                            str(d)), nprocs=world, join=False,
        start_method="spawn")
    for p in ctx.processes:
        p.join(240)
    alive = [p for p in ctx.processes if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "an engine rank did not finish within 240 s"
    assert ctx.join(), "the engine ranks did not exit"
    out = []
    for r in range(world):
        with open(d / f"rank{r}.json") as f:
            out.append((dict(np.load(d / f"rank{r}.npz")), json.load(f)))
    return out


@pytest.fixture(scope="module")
def engine2(ref, tmp_path_factory):
    return _spawn(2, ref, tmp_path_factory)


@pytest.fixture(scope="module")
def engine4(ref, tmp_path_factory):
    return _spawn(4, ref, tmp_path_factory)


def _assemble(ranks: list, name: str, what: str, data_index: int) -> dict:
    """One data replica's tree of ``what`` from its stages: every stage's
    rows of ``blocks`` in stage order, the shared leaves from stage 0."""
    mine = sorted(((m[name]["stage"], got) for got, m in ranks
                   if m[name]["data"] == data_index), key=lambda x: x[0])
    pre = f"{name}/{what}/"
    out = {}
    for key in (k for k in mine[0][1] if k.startswith(pre)):
        path = key[len(pre):]
        out[path] = (np.concatenate([got[key] for _, got in mine])
                     if path.startswith("blocks/") else mine[0][1][key])
    return out


@pytest.mark.parametrize("world,name", [(w, n) for w in ENGINE
                                        for n in ENGINE[w]])
def test_engine_matches_reference(world, name, ref, request):
    ranks = request.getfixturevalue(f"engine{world}")
    pp, dp, sched, sl, tied, mbs = ENGINE[world][name]
    r = ref[tied]
    # the reference: its interpreter on the whole batch (a data-parallel
    # mean over replicas is the whole batch's gradient)
    want_loss, want_grads, _ = r[sched, sl]
    per_stage = make_schedule(sched, pp, mbs).per_stage_in_flight()
    for got, meta in ranks:
        m = meta[name]
        np.testing.assert_allclose(m["loss"], want_loss, atol=TOL.fwd,
                                   rtol=TOL.fwd)
        assert m["peak"] == per_stage[m["stage"]]
        # the shared leaves are summed over the stages: each rank holds all
        for path in ("embed/table", "final_norm/scale") + (
                () if tied else ("head/w",)):
            np.testing.assert_allclose(got[f"{name}/grads/{path}"],
                                       want_grads[path], atol=TOL.grad,
                                       rtol=TOL.grad, err_msg=path)
    init = {k: jnp.asarray(v) for k, v in r["params"].items()}
    opt = jax_opt.adamw(lr=LR)
    for d in range(dp):
        handed = _assemble(ranks, name, "grads", d)
        _close(handed, want_grads, TOL.grad, f"{name} replica {d} grads")
        # clipped by the whole model's norm: the reference's AdamW of the
        # gradient the ranks handed over gives the parameters they hold
        norm = float(jax_opt.global_norm(handed))
        assert norm > 1.0                          # the clip acts
        for got, meta in ranks:
            np.testing.assert_allclose(meta[name]["norm"], norm, rtol=1e-5)
        new, _ = opt.apply({k: jnp.asarray(v) for k, v in handed.items()},
                           opt.init(init), init, 0)
        _close(_assemble(ranks, name, "params", d), _np(new), 1e-3 * LR,
               f"{name} replica {d} params")


def test_engine_init_and_guards(engine2):
    _, cfg = _cfgs(False)
    whole = _pt(Model(cfg, "cpu").init(0))
    rows = {0: slice(0, 3), 1: slice(3, 4)}
    for got, meta in engine2:
        stage = meta["gpipe_even"]["stage"]
        for path, v in whole.items():
            want = v[rows[stage]] if path.startswith("blocks/") else v
            np.testing.assert_array_equal(got[f"init/{path}"], want,
                                          err_msg=path)
        assert "sums to 3" in meta["bad_layers"]
    with pytest.raises(ValueError, match="pipeline step needs pp > 1"):
        planner.compile_plan(Model(cfg, "cpu"), None).pipeline_train_step_fn(
            adamw())
