"""The port's MoE family (``repro_torch.models.moe`` and the moe branch of
``models/lm.py``) against the reference (``repro.models.moe``,
``repro.models.lm``) on the CPU, with the same numpy inputs and the
reference's weights crossed over by ``params_from_numpy``.  Tolerances
(tests/torch_harness.py): f32 values 2e-5, gradients 2e-4.

- ``_dispatch_indices`` equal with ``==``, capacity drops and unfilled
  slots (both sentinels) included;
- ``moe_block``'s output, ``lb_loss``, ``z_loss``, ``expert_load`` and VJP
  with 0 and 1 shared experts, with and without forced drops;
- the deepseek-moe-16b smoke model: loss, metrics and every gradient leaf
  under remat none, full and dots; prefill, ``serve_step`` and
  ``serve_step_paged`` logits and greedy tokens;
- one spawn of 2 gloo ranks: ``moe_block_ep`` over 2 ranks against the
  reference's ``moe_block``, and the split with the experts over the
  model axis, ``StrategySpec(tp=2, ep=2)``, its step-0 loss and every
  gathered gradient leaf against the reference's unmeshed ``loss_fn`` and
  three AdamW steps against its optimizer loop;
- one spawn of 4 gloo ranks: ``moe_block_ep`` over 4 ranks, and the M6
  nesting ``replica{split[experts]}`` recorded as annotations at data 2 x
  model 2, lowered by ``compile_nested_plan`` to ``dp=2, ep=2`` and
  trained one step: each data replica routes its own rows and the experts
  balance over the global batch, so the loss and gradients are the
  reference's ``loss_fn`` on the whole batch.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch as wh
from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.optim import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro_torch.tree import flatten, tree_map

from torch_harness import TOLS

ARCH = "deepseek-moe-16b"
TOL = TOLS["float32"]
LR = 1e-3
B, T = 4, 16                      # the smoke model's batch
STEPS = 3
D, E, K, FF = 32, 8, 2, 16        # moe_block's test shapes
BB, SS = 4, 64


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


def _mcfg(n_shared: int, cf: float):
    kw = dict(d_model=D, n_experts=E, top_k=K, d_ff_expert=FF,
              n_shared=n_shared, capacity_factor=cf)
    return ref_moe.MoECfg(**kw), moe.MoECfg(**kw)


def _block_inputs(n_shared: int, seed: int = 0) -> dict:
    """Weights, x and the cotangents of (y, lb_loss, z_loss), from numpy;
    the router's columns skewed so some experts overflow and some stay
    short of their capacity."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    router = f(D, E) / np.sqrt(D)
    router[:, :3] *= 3.0
    p = {"router": {"w": router}, "w_in": f(E, D, FF) / np.sqrt(D),
         "w_gate": f(E, D, FF) / np.sqrt(D),
         "w_out": f(E, FF, D) / np.sqrt(FF)}
    if n_shared:
        p["shared"] = {"wi": f(D, FF * n_shared) / np.sqrt(D),
                       "wg": f(D, FF * n_shared) / np.sqrt(D),
                       "wo": f(FF * n_shared, D) / np.sqrt(FF)}
    return {"params": p, "x": f(BB, SS, D), "ct": f(BB, SS, D),
            "ct_lb": np.float32(0.7), "ct_z": np.float32(1.3)}


def _ref_block(inp: dict, cfg) -> dict:
    """The reference's ``moe_block`` value and VJP on the whole batch."""
    def fn(p, x):
        y, aux = ref_moe.moe_block(p, x, cfg)
        return y, aux["lb_loss"], aux["z_loss"]

    @jax.jit
    def value_and_vjp(p, x, cts):
        out, vjp = jax.vjp(fn, p, x)
        return out, vjp(cts), ref_moe.moe_block(p, x, cfg)[1]

    p = jax.tree.map(jnp.asarray, inp["params"])
    (y, lb, z), (gp, gx), aux = value_and_vjp(
        p, jnp.asarray(inp["x"]), (jnp.asarray(inp["ct"]),
                                   jnp.asarray(inp["ct_lb"]),
                                   jnp.asarray(inp["ct_z"])))
    return {"y": np.asarray(y), "lb": float(lb), "z": float(z),
            "load": np.asarray(aux["expert_load"]), "gx": np.asarray(gx),
            "gp": _np(gp)}


def _leaves_t(tree: dict) -> dict:
    return {k: torch.tensor(v, requires_grad=True) if not isinstance(v, dict)
            else _leaves_t(v) for k, v in tree.items()}


def _paths(tree: dict) -> dict:
    return dict(zip(*flatten(tree)))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def test_dispatch_indices_equal_with_drops():
    """Token indices and weights of every slot, equal with ``==``: a
    capacity of 8 for 128 assignments of a skewed routing drops some
    (sentinel slot E·C) and leaves some slots empty (token S)."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, SS, E)).astype(np.float32)
    logits[..., :2] += 2.0
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    w, idx = jax.lax.top_k(jnp.asarray(probs), K)
    C = 8
    want_tok, want_w = ref_moe._dispatch_indices(idx, w, E, C, SS)
    tok, wt = moe._dispatch_indices(torch.tensor(np.asarray(idx)).long(),
                                    torch.tensor(np.asarray(w)), E, C, SS)
    assert np.array_equal(tok.numpy(), np.asarray(want_tok))
    assert np.array_equal(wt.numpy(), np.asarray(want_w))
    assert (tok.numpy() == SS).any()                 # unfilled slots
    assert (tok.numpy() < SS).sum() < 3 * SS * K     # dropped assignments


@pytest.mark.parametrize("n_shared,cf", [(0, 1.25), (1, 1.25), (1, 0.25)],
                         ids=["routed", "shared", "shared_drops"])
def test_moe_block_matches_reference(n_shared, cf):
    rcfg, cfg = _mcfg(n_shared, cf)
    inp = _block_inputs(n_shared)
    want = _ref_block(inp, rcfg)
    p, x = _leaves_t(inp["params"]), torch.tensor(inp["x"],
                                                  requires_grad=True)
    y, aux = moe.moe_block(p, x, cfg)
    np.testing.assert_allclose(y.detach().numpy(), want["y"], atol=TOL.fwd,
                               rtol=TOL.fwd)
    np.testing.assert_allclose(aux["lb_loss"].item(), want["lb"],
                               atol=TOL.fwd, rtol=TOL.fwd)
    np.testing.assert_allclose(aux["z_loss"].item(), want["z"],
                               atol=TOL.fwd, rtol=TOL.fwd)
    np.testing.assert_array_equal(aux["expert_load"].numpy(), want["load"])
    assert not aux["expert_load"].requires_grad
    loss = (y * torch.tensor(inp["ct"])).sum() \
        + float(inp["ct_lb"]) * aux["lb_loss"] \
        + float(inp["ct_z"]) * aux["z_loss"]
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), want["gx"], atol=TOL.grad,
                               rtol=TOL.grad)
    got = _paths(p)
    assert sorted(got) == sorted(want["gp"])
    for path, w in want["gp"].items():
        np.testing.assert_allclose(got[path].grad.numpy(), w, atol=TOL.grad,
                                   rtol=TOL.grad, err_msg=path)


def test_activations_other_than_silu_name_their_item():
    """gelu and relu, the rest of the reference's table, run; an
    activation outside it raises, naming the table's entries."""
    _, cfg = _mcfg(0, 1.25)
    inp = _block_inputs(0)
    for act in ("gelu", "relu"):
        y, _ = moe.moe_block(_leaves_t(inp["params"]), torch.tensor(inp["x"]),
                             dataclasses.replace(cfg, act=act))
        assert torch.isfinite(y).all()
    with pytest.raises(ValueError, match="'gelu', 'relu', 'silu'"):
        moe.moe_block(_leaves_t(inp["params"]), torch.tensor(inp["x"]),
                      dataclasses.replace(cfg, act="swish"))
    with pytest.raises(ValueError, match="'gelu', 'relu', 'silu'"):
        Model(dataclasses.replace(get_config(ARCH, smoke=True), act="swish"),
              "cpu")


# ---------------------------------------------------------------------------
# the deepseek smoke model
# ---------------------------------------------------------------------------

def _cfgs(remat: str = "none", **kw):
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True),
                                remat=remat, **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), remat=remat,
                                **kw))


@pytest.fixture(scope="module")
def smoke():
    """The reference's smoke weights (numpy), tokens, its unmeshed loss
    and gradients on the whole batch, and three AdamW steps' losses."""
    jcfg, _ = _cfgs()
    jm = ref_lm.build(jcfg)
    params = jax.jit(jm.init)(jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (B, T)).astype(
        np.int32)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    out = {"tokens": tokens, "params": _np(params), "jm": jm, "jp": params}
    (loss, m), g = grad_fn(params, {"tokens": jnp.asarray(tokens)})
    out["whole"] = (float(loss), {k: float(v) for k, v in m.items()}, _np(g))
    opt = jax_opt.adamw(lr=LR)
    apply = jax.jit(opt.apply)
    p, st, losses = params, opt.init(params), []
    for i in range(STEPS):
        (loss, _), g = grad_fn(p, {"tokens": jnp.asarray(tokens)})
        p, st = apply(g, st, p, i)
        losses.append(float(loss))
    out["losses"] = losses
    return out


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_smoke_loss_and_every_gradient_match_reference(smoke, remat):
    _, cfg = _cfgs(remat)
    params = params_from_numpy(cfg, smoke["params"], "cpu")
    for v in flatten(params)[1]:
        v.requires_grad_(True)
    loss, m = Model(cfg, "cpu").loss_fn(
        params, {"tokens": torch.tensor(smoke["tokens"])})
    want_loss, want_m, want_g = smoke["whole"]
    np.testing.assert_allclose(loss.item(), want_loss, atol=TOL.fwd,
                               rtol=TOL.fwd)
    assert sorted(m) == sorted(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(m[k].item(), v, atol=TOL.fwd,
                                   rtol=TOL.fwd, err_msg=k)
    assert m["moe_lb"].item() > 0 and m["moe_z"].item() > 0
    loss.backward()
    got = dict(zip(*flatten(params)))
    assert sorted(got) == sorted(want_g)
    for path, w in want_g.items():
        np.testing.assert_allclose(got[path].grad.numpy(), w, atol=TOL.grad,
                                   rtol=TOL.grad, err_msg=path)


def test_router_stays_f32_and_serving_keeps_it():
    _, cfg = _cfgs(param_dtype="bfloat16", dtype="bfloat16")
    model = Model(cfg, "cpu")
    params = model.init(0)
    router = params["blocks"]["p0"]["moe"]["router"]["w"]
    assert router.dtype == torch.float32
    assert params["blocks"]["p0"]["moe"]["w_in"].dtype == torch.bfloat16
    served = model.serving_params(params)
    assert served["blocks"]["p0"]["moe"]["router"]["w"] is router


def _serving_pair(smoke):
    _, cfg = _cfgs()
    return (smoke["jm"], smoke["jp"], Model(cfg, "cpu"),
            params_from_numpy(cfg, smoke["params"], "cpu"))


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL.fwd,
                               rtol=TOL.fwd)


def test_prefill_and_decode_match_reference(smoke):
    """Prefill (ragged ``last_idx``), then 4 greedy ``serve_step``s, each
    step's logits and the argmax tokens equal."""
    jm, jp, tm, tp = _serving_pair(smoke)
    tokens = smoke["tokens"][:2]
    last = [9, 15]
    jl, jst = jax.jit(jm.prefill, static_argnames="gen_budget")(
        jp, {"tokens": jnp.asarray(tokens)}, gen_budget=8,
        last_idx=jnp.asarray(last))
    step = jax.jit(jm.serve_step)
    with torch.no_grad():
        tl, st = tm.prefill(tp, {"tokens": torch.tensor(tokens)},
                            gen_budget=8, last_idx=torch.tensor(last))
        _close(tl, jl)
        for key in ("k", "v"):
            _close(st["cache"]["p0"][key], jst["cache"]["p0"][key])
        for _ in range(4):
            nxt = np.asarray(jnp.argmax(jl[:, :tm.cfg.vocab], -1))
            assert np.array_equal(tl[:, :tm.cfg.vocab].argmax(-1).numpy(),
                                  nxt)
            tl, st = tm.serve_step(tp, torch.tensor(nxt), st)
            jl, jst = step(jp, jnp.asarray(nxt, jnp.int32), jst)
            _close(tl, jl)


def test_serve_step_paged_matches_reference(smoke):
    """The paged decode against the reference's over the same pools built
    from one prefill: logits of 3 steps and the pools after them."""
    jm, jp, tm, tp = _serving_pair(smoke)
    ps, mp, P = 4, 8, 13
    tokens = smoke["tokens"][:2]
    with torch.no_grad():
        _, st = tm.prefill(tp, {"tokens": torch.tensor(tokens)},
                           gen_budget=0, last_idx=torch.tensor([9, 15]))
    table = np.zeros((2, mp), np.int32)
    table[0, :4] = [3, 7, 1, 6]
    table[1, :5] = [2, 9, 4, 5, 8]
    pools = {}
    for key in ("k", "v"):
        cache = st["cache"]["p0"][key].numpy()       # (L, 2, 16, K, D)
        pool = np.zeros((cache.shape[0], P, ps) + cache.shape[3:],
                        np.float32)
        for b, n in ((0, 3), (1, 4)):
            for j in range(n):
                pool[:, table[b, j]] = cache[:, b, j * ps:(j + 1) * ps]
        pools[key] = pool
    pos = np.array([10, 16], np.int32)
    tstate = {"pools": {"p0": {k: torch.tensor(v) for k, v in pools.items()}},
              "block_table": torch.tensor(table), "pos": torch.tensor(pos)}
    jstate = {"pools": {"p0": {k: jnp.asarray(v) for k, v in pools.items()}},
              "block_table": jnp.asarray(table), "pos": jnp.asarray(pos)}
    rng = np.random.default_rng(5)
    step = jax.jit(jm.serve_step_paged)
    with torch.no_grad():
        for _ in range(3):
            nxt = rng.integers(0, tm.cfg.vocab, (2,))
            tl, tstate = tm.serve_step_paged(tp, torch.tensor(nxt), tstate)
            jl, jstate = step(jp, jnp.asarray(nxt, jnp.int32), jstate)
            _close(tl, jl)
    for key in ("k", "v"):
        _close(tstate["pools"]["p0"][key], jstate["pools"]["p0"][key])


def test_moe_refusals_name_their_item(monkeypatch):
    """The experts' d_ff split (grok-1's expert tensor parallelism, once
    refused): where the 2-way axis does not divide 3 experts the block
    splits ``expert_mlp``, and the two ranks' row-parallel partials (the
    collectives taken out: the combine's all-reduce is their sum) add up
    to the reference's ``moe_block`` on the whole experts; the aux losses
    are whole on each rank."""
    inp = _block_inputs(0)
    p = inp["params"]
    p = {"router": {"w": np.ascontiguousarray(p["router"]["w"][:, :3])},
         **{k: np.ascontiguousarray(p[k][:3])
            for k in ("w_in", "w_gate", "w_out")}}
    jcfg, mcfg = (dataclasses.replace(c, n_experts=3) for c in _mcfg(0, 1.25))
    want = _ref_block(dict(inp, params=p), jcfg)
    monkeypatch.setattr(sharding, "copy_to", lambda x, split: x)
    monkeypatch.setattr(sharding, "reduce_from", lambda x, split: x)
    ys = []
    for r in range(2):
        mesh = _OneAxis(r)
        rules = sharding.ShardingRules(shape={"model": 2}, rules={
            "experts": "model", "expert_mlp": "model", "mlp": "model"},
            mesh=mesh)
        with sharding.use_rules(rules):
            split, dim = moe._expert_split(mcfg)
            assert (dim, split.n, split.index) == ("expert_mlp", 2, r)
            half = {"router": {"w": torch.tensor(p["router"]["w"])},
                    "w_in": torch.tensor(p["w_in"][..., r * 8:(r + 1) * 8]),
                    "w_gate": torch.tensor(
                        p["w_gate"][..., r * 8:(r + 1) * 8]),
                    "w_out": torch.tensor(p["w_out"][:, r * 8:(r + 1) * 8])}
            y, aux = moe.moe_block(half, torch.tensor(inp["x"]), mcfg)
        ys.append(y)
        np.testing.assert_allclose(float(aux["lb_loss"]), want["lb"],
                                   atol=TOL.fwd, rtol=TOL.fwd)
        np.testing.assert_allclose(float(aux["z_loss"]), want["z"],
                                   atol=TOL.fwd, rtol=TOL.fwd)
    np.testing.assert_allclose((ys[0] + ys[1]).numpy(), want["y"],
                               atol=TOL.fwd, rtol=TOL.fwd)


class _OneAxis:
    """What ``split_of`` reads of a 2-way mesh without a process group:
    this rank's place ``rank`` on it."""

    def __init__(self, rank: int = 0):
        self.rank = rank

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return self.rank


# ---------------------------------------------------------------------------
# gloo ranks: moe_block_ep, the split (tp=2, ep=2) and the M6 nesting
# ---------------------------------------------------------------------------

def _spy(opt, seen: dict):
    real_apply = opt.apply

    def apply(grads, state, p, step, **kw):
        if step == 0:
            seen["grads"] = tree_map(torch.clone, grads)
        return real_apply(grads, state, p, step, **kw)

    return dataclasses.replace(opt, apply=apply)


def _ep_case(world: int, d: dict, res: dict) -> None:
    """``moe_block_ep`` on this rank's rows and experts, the loss the
    sum of its rows' cotangent products plus the aux terms once."""
    rank = dist.get_rank()
    inp = {k[len("blk/"):]: v for k, v in d.items() if k.startswith("blk/")}
    bl, el = BB // world, E // world
    p = {}
    for path, v in inp.items():
        if not path.startswith("params/"):
            continue
        leaf = torch.tensor(v[rank * el:(rank + 1) * el] if path.split("/")[-1]
                            in ("w_in", "w_gate", "w_out") else v)
        node = p
        *parents, name = path[len("params/"):].split("/")
        for q in parents:
            node = node.setdefault(q, {})
        node[name] = leaf.requires_grad_(True)
    x = torch.tensor(inp["x"][rank * bl:(rank + 1) * bl], requires_grad=True)
    _, cfg = _mcfg(1, 1.25)
    y, aux = moe.moe_block_ep(p, x, cfg, dist.group.WORLD)
    loss = (y * torch.tensor(inp["ct"][rank * bl:(rank + 1) * bl])).sum() \
        + float(inp["ct_lb"]) * aux["lb_loss"] \
        + float(inp["ct_z"]) * aux["z_loss"]
    loss.backward()
    out = {"y": y, "gx": x.grad, "lb": aux["lb_loss"], "z": aux["z_loss"],
           "load": aux["expert_load"],
           **{f"gp/{k}": v.grad for k, v in _paths(p).items()}}
    for k, v in out.items():
        t = v.detach().contiguous()
        if k in ("y", "gx") or k.split("/")[-1] in ("w_in", "w_gate",
                                                    "w_out"):
            t = sharding.gather_cat(t, dist.group.WORLD, 0)
        res[f"ep/{k}"] = t.numpy()


def _split_case(d: dict, res: dict, meta: dict) -> None:
    """``StrategySpec(tp=2, ep=2)``: 3 AdamW steps, the step-0 gradients
    gathered."""
    _, cfg = _cfgs()
    model = Model(cfg, "cpu")
    strat = StrategySpec(tp=2, ep=2)
    plan = planner.compile_plan(
        model, planner.mesh_for_strategy(strat, device_type="cpu"), strat)
    _train(plan, d, res, meta, "split", STEPS)


def _train(plan, d, res, meta, name, steps):
    full = params_from_numpy(plan.model.cfg, {
        k[2:]: v for k, v in d.items() if k.startswith("p/")}, "cpu")
    params = plan.shard(full, plan.param_specs)
    seen = {}
    opt = _spy(adamw(lr=LR), seen)
    state = {"params": params, "opt": plan.init_opt(opt, params)}
    step = plan.train_step_fn(opt)
    batch = plan.batch_slice({"tokens": torch.tensor(d["tokens"])})
    losses = []
    for i in range(steps):
        p, o, m = step(state["params"], state["opt"], batch, i)
        state = {"params": p, "opt": o}
        losses.append(float(m["loss"]))
    grads = tree_map(lambda g, s: sharding.gather_leaf(g, s, plan.rules),
                     seen["grads"], plan.param_specs)
    meta[name] = {"losses": losses, "strategy": plan.strategy.describe(),
                  "experts_local": params["blocks"]["p0"]["moe"][
                      "w_in"].shape[1]}
    for path, v in zip(*flatten(grads)):
        res[f"{name}/grads/{path}"] = v.detach().numpy()


def _m6_case(d: dict, res: dict, meta: dict) -> None:
    """The M6 nesting recorded at data 2 x model 2 and compiled by
    ``compile_nested_plan``: one step."""
    cl = wh.cluster(mesh_shape=(2, 2), axis_names=("data", "model"),
                    device_type="cpu")
    w = {"w": torch.ones((8, 8))}
    net = lambda p, x: x @ p["w"]
    with cl:
        with wh.replica():
            h = wh.sub("attn", net)(w, torch.ones((4, 8)))
            with wh.split(experts=True):
                h = wh.sub("moe", net)(w, h)
            wh.sub("out", net)(w, h)
    _, cfg = _cfgs()
    plan = wh.compile_nested_plan(cl, Model(cfg, "cpu"))
    _train(plan, d, res, meta, "m6", 1)


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    d = dict(np.load(inputs))
    res, meta = {}, {}
    _ep_case(world, d, res)
    if world == 2:
        _split_case(d, res, meta)
    else:
        _m6_case(d, res, meta)
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _spawn(world: int, d, smoke, blk) -> tuple:
    import torch.multiprocessing as mp
    np.savez(d / "inputs.npz", tokens=smoke["tokens"],
             **{f"p/{k}": v for k, v in smoke["params"].items()},
             **{f"blk/{k}": v for k, v in _paths(blk).items()})
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
    return dict(np.load(d / "rank0.npz")), metas


@pytest.fixture(scope="module")
def block_ref():
    inp = _block_inputs(1)
    return {"params": inp["params"], "x": inp["x"], "ct": inp["ct"],
            "ct_lb": np.asarray(inp["ct_lb"]),
            "ct_z": np.asarray(inp["ct_z"])}, _ref_block(
        inp, _mcfg(1, 1.25)[0])


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def ranks(request, smoke, block_ref, tmp_path_factory):
    world = request.param
    return world, _spawn(world, tmp_path_factory.mktemp(f"moe{world}"),
                         smoke, block_ref[0])


def test_moe_block_ep_matches_reference(ranks, block_ref):
    """``moe_block_ep`` over 2 and 4 ranks: the rows' outputs, the aux
    losses and loads, the rows' input gradients, the router's and shared
    experts' gradients (whole on every rank) and each rank's experts'
    against the reference's ``moe_block`` on the whole batch."""
    _, (res, _) = ranks
    want = block_ref[1]
    np.testing.assert_allclose(res["ep/y"], want["y"], atol=TOL.fwd,
                               rtol=TOL.fwd)
    np.testing.assert_allclose(res["ep/lb"], want["lb"], atol=TOL.fwd,
                               rtol=TOL.fwd)
    np.testing.assert_allclose(res["ep/z"], want["z"], atol=TOL.fwd,
                               rtol=TOL.fwd)
    np.testing.assert_allclose(res["ep/load"], want["load"], atol=TOL.fwd,
                               rtol=TOL.fwd)
    np.testing.assert_allclose(res["ep/gx"], want["gx"], atol=TOL.grad,
                               rtol=TOL.grad)
    for path, w in want["gp"].items():
        np.testing.assert_allclose(res[f"ep/gp/{path}"], w, atol=TOL.grad,
                                   rtol=TOL.grad, err_msg=path)


def test_split_experts_step_matches_reference(ranks, smoke):
    """2 ranks, ``StrategySpec(tp=2, ep=2)``: each rank holds 4 of the 8
    experts; the step-0 loss and every gathered gradient leaf against the
    reference's unmeshed ``loss_fn``, three AdamW steps' losses against
    its optimizer loop, every rank alike.  4 ranks, the M6 nesting: the
    plan ``compile_nested_plan`` lowers is ``replica×2{split[experts]×2}``
    (dp 2, ep 2, the vocab whole), and its step's loss and gradients are
    the reference's unmeshed ``loss_fn`` on the whole global batch: the
    experts balance over it, not over each replica's rows."""
    world, (res, metas) = ranks
    name = "split" if world == 2 else "m6"
    got = metas[0][name]
    assert all(m[name]["losses"] == got["losses"] for m in metas)
    assert got["experts_local"] == E_SMOKE // 2
    want_loss, _, want_g = smoke["whole"]
    if world == 2:
        np.testing.assert_allclose(got["losses"], smoke["losses"],
                                   atol=TOL.fwd, rtol=TOL.fwd)
    else:
        assert "split[experts]×2" in got["strategy"]
    np.testing.assert_allclose(got["losses"][0], want_loss, atol=TOL.fwd,
                               rtol=TOL.fwd)
    grads = {k[len(f"{name}/grads/"):]: v for k, v in res.items()
             if k.startswith(f"{name}/grads/")}
    assert sorted(grads) == sorted(want_g)
    for path, w in want_g.items():
        np.testing.assert_allclose(grads[path], w, atol=TOL.grad,
                                   rtol=TOL.grad, err_msg=path)


E_SMOKE = get_config(ARCH, smoke=True).n_experts
