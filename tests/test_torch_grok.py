"""grok-1-314b in the port against the reference (``repro``) on the CPU:
its config, its smoke model, the experts' d_ff split over ``model``
(grok's expert tensor parallelism), Adafactor over blocks of its leaves,
and paged decode at its group of 6.

In this process:

- ``CONFIG`` and ``SMOKE`` field for field against the reference's;
- the smoke model's prefill logits, loss, metrics and every gradient
  leaf against the reference's ``prefill`` and ``loss_fn``;
- the port's chunked Adafactor (chunks of whole matrices and of rows of
  one matrix), its clip folded into each leaf, against the reference's
  whole-leaf ``adafactor`` over three steps with the clip active;
- ``planner.accumulate``'s in-place sums against the sums into new
  tensors it made before, bit for bit;
- paged decode's plain version at group 6 (48/8 and a rank's 24/4 heads
  scaled down) against the reference's kernel in interpret mode.

One spawn of 4 gloo ranks (``torch.multiprocessing`` over a
``FileStore``), its cases on the smoke model with ``n_experts=3``, which
a 2-way model axis does not divide, so the rules split every expert's
d_ff (``expert_mlp``) as they split grok's 8 experts on the reference's
16-way axis:

- ``data 2 × model 2`` with ZeRO 0, 1 and 3, Adafactor: the step-0 loss
  and every gathered gradient leaf against the reference's unmeshed
  ``loss_fn`` on the whole batch, the losses of AF_STEPS steps and the
  gathered parameters and factored moments after them against its
  ``adafactor`` loop on the unsharded leaves; ZeRO-1's and ZeRO-3's
  checkpoints restored into their ranks' blocks bit for bit, and ZeRO-3's
  restored into ZeRO-1's plan, whose next step is the reference's;
- ``pipeline{split}`` (stage 2 × model 2, 1f1b, 2 micro-batches) with
  Adafactor against the reference's ``adafactor`` on the mean of its
  micro-batches' gradients;
- serving at ``data 2 × model 2`` with grok's group of 6 (12 q over 2 kv
  heads): prefill logits, dense and paged teacher-forced steps against
  the reference's ``prefill``, ``serve_step`` and ``serve_step_paged``.

Tolerances (tests/torch_harness.py): f32 values 2e-5, gradients,
parameters and moments 2e-4 (sums over shards are not bit-equal to one
whole mean).
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
from repro.kernels.flash_attention.paged import paged_decode as jax_paged
from repro.models import lm as ref_lm
from repro.optim import optimizer as jax_opt
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.kernels.flash_attention import paged
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim import optimizer as opt
from repro_torch.tree import flatten, tree_map

from torch_harness import TOL as VTOL
from torch_harness import TOLS, close, paged_inputs

pipe = importlib.import_module("repro_torch.core.pipeline")

ARCH = "grok-1-314b"
TOL = TOLS["float32"]
LR = 1e-2
B, T = 4, 16
AF_STEPS = 2
WORLD = 4
#: the training cases on the 4 ranks: name -> strategy
TRAIN = {"zero0": StrategySpec(dp=2, tp=2),
         "zero1": StrategySpec(dp=2, tp=2, zero=1),
         "zero3": StrategySpec(dp=2, tp=2, zero=3)}
PIPE = StrategySpec(tp=2, pp=2, micro_batches=2, schedule="1f1b")
# serving: slots, prompt bucket, last prompt index, steps, gen budget,
# paged pools
SB, SS = 4, 16
LAST = [9, 15, 4, 12]
STEPS = 4
GB = 8
PS, MP, P = 4, 8, 29


def _cfg(get, **kw):
    return dataclasses.replace(get(ARCH, smoke=True), n_experts=3, **kw)


def _serve_cfg(get):
    """Grok's group of 6 at the smoke's width: 12 q over 2 kv heads (one
    kv head a rank at model 2, the ``grouped`` layout decode takes)."""
    return _cfg(get, n_heads=12, n_kv_heads=2)


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


def _fclose(got, want, tol=TOL.fwd, msg=""):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for path in want:
        _fclose(got[path], want[path], tol, f"{what} {path}")


def _tree(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


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


def _ref_training(out: dict) -> None:
    jm = ref_lm.build(_cfg(jax_get_config))
    params = jax.jit(jm.init)(jax.random.key(1))
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab, (B, T)).astype(np.int32)
    out["tokens"], out["params"] = toks, _np(params)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    (loss, _), g = grad_fn(params, {"tokens": jnp.asarray(toks)})
    out["loss"], out["grads"] = float(loss), _np(g)
    o = jax_opt.adafactor(lr=LR)
    apply = jax.jit(o.apply)
    # the whole batch (data 2: the experts balance over it), and the mean
    # of two micro-batches' (the pipeline's)
    for name, micro in (("whole", 1), ("micro", 2)):
        p, st, losses = params, o.init(params), []
        for step in range(AF_STEPS + 1):
            parts = [grad_fn(p, {"tokens": jnp.asarray(t)})
                     for t in np.split(toks, micro)]
            losses.append(float(np.mean([float(x[0][0]) for x in parts])))
            g = jax.tree.map(lambda *x: sum(x) / micro,
                             *[x[1] for x in parts])
            if step == AF_STEPS:
                break
            p, st = apply(g, st, p, step)
            if step == AF_STEPS - 1:
                out[name, "state"] = _np({"params": p, "opt": st})
        out[name, "losses"] = losses


def _ref_serving(out: dict) -> None:
    jm = ref_lm.build(_serve_cfg(jax_get_config))
    jp = jax.jit(jm.init)(jax.random.key(2))
    out["s_params"] = _np(jp)
    rng = np.random.default_rng(3)
    V = jm.cfg.vocab
    out["s_tokens"] = rng.integers(0, V, (SB, SS)).astype(np.int32)
    out["s_steps"] = rng.integers(0, V, (STEPS, SB)).astype(np.int32)
    step = jax.jit(jm.serve_step)
    for gb in (0, GB):
        logits, st = jm.prefill(jp, {"tokens": jnp.asarray(out["s_tokens"])},
                                gen_budget=gb, last_idx=jnp.asarray(LAST))
        out["prefill", gb] = (np.asarray(logits), _np(st["cache"]["p0"]))
    lg = []
    for t in range(STEPS):
        logits, st = step(jp, jnp.asarray(out["s_steps"][t]), st)
        lg.append(np.asarray(logits))
    out["dense"] = np.stack(lg)
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


@pytest.fixture(scope="module")
def ref():
    """The reference on the smoke model with 3 experts: ``loss_fn`` and
    its gradients on the whole batch, its ``adafactor`` loop over the
    whole batch and over two micro-batches; its serving at grok's group
    of 6."""
    out = {}
    _ref_training(out)
    _ref_serving(out)
    return out


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """Every field of ``CONFIG`` and ``SMOKE`` (the reference's
    ``shrink``) equals the reference's; the layer is 4.920e9 parameters,
    as reckoned (experts 4.832e9, attention 88.1e6)."""
    for smoke in (False, True):
        ours = dataclasses.asdict(get_config(ARCH, smoke=smoke))
        theirs = dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))
        assert {k: theirs[k] for k in ours} == ours
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.n_experts, cfg.d_ff_expert, cfg.top_k,
            cfg.vocab, cfg.act, cfg.tie_embeddings) == (
        64, 6144, 48, 8, 128, 8, 32768, 2, 131072, "gelu", False)
    shapes = Model(dataclasses.replace(cfg, n_layers=1), "meta").param_shapes()
    n = {p: x.numel() for p, x in zip(*flatten(shapes))}
    experts = sum(v for p, v in n.items() if "/moe/w_" in p)
    attn = sum(v for p, v in n.items() if "/attn/" in p)
    assert experts == 8 * 3 * 6144 * 32768
    assert attn == 88_080_384
    assert n["embed/table"] + n["head/w"] == 2 * 131072 * 6144


def test_smoke_forward_loss_and_grads_match_reference():
    """The 8-expert smoke model: prefill logits, the loss, its metrics and
    every gradient leaf against the reference's on the same weights."""
    jm = ref_lm.build(jax_get_config(ARCH, smoke=True))
    jp = jm.init(jax.random.key(0))
    toks = np.random.default_rng(5).integers(0, 512, (B, T)).astype(np.int32)
    (loss, m), g = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks)})
    logits, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    cfg = get_config(ARCH, smoke=True)
    model = Model(cfg, "cpu")
    params = params_from_numpy(cfg, _np(jp), "cpu")
    with torch.no_grad():
        got, _ = model.prefill(params, {"tokens": torch.tensor(toks)})
    _fclose(got.numpy()[..., :cfg.vocab], np.asarray(logits)[..., :cfg.vocab])
    l2, m2, g2 = planner.loss_and_grads(model, params,
                                        {"tokens": torch.tensor(toks)})
    _fclose(float(l2), float(loss))
    for k in ("moe_lb", "moe_z", "nll"):
        _fclose(float(m2[k]), float(m[k]), msg=k)
    _close({p: x.numpy() for p, x in zip(*flatten(g2))}, _np(g), TOL.grad,
           "smoke gradients")


def _af_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"experts": f(2, 3, 12, 10), "mat": f(40, 24), "vec": f(7),
            "stack": f(3, 5, 8)}


@pytest.mark.parametrize("chunk", [24, 130, opt.ADAFACTOR_CHUNK])
def test_chunked_adafactor_matches_whole_leaf_reference(chunk, monkeypatch):
    """The port's Adafactor in chunks of ``chunk`` elements (24: rows of
    one matrix; 130: whole matrices a chunk; the default: a leaf a chunk),
    the clip's factor folded into each leaf (max norm 0.5, so it clips),
    against the reference's whole-leaf update over three steps: the
    parameters and the factored moments."""
    monkeypatch.setattr(opt, "ADAFACTOR_CHUNK", chunk)
    sched = dict(base_lr=1e-2, warmup=2, decay_steps=3)
    jo = jax_opt.adafactor(lr=jax_opt.Schedule(**sched), max_grad_norm=0.5)
    to = opt.adafactor(lr=opt.Schedule(**sched), max_grad_norm=0.5)
    jp = jax.tree.map(jnp.asarray, _af_tree(0))
    tp = tree_map(torch.tensor, _af_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = _af_tree(step + 1)
        jp, js = jo.apply(jax.tree.map(jnp.asarray, g), js, jp, step)
        tp, ts = to.apply(tree_map(torch.tensor, g), ts, tp, step)
        want = _np({"p": jp, "s": js})
        got = {p: x.numpy() for p, x in zip(*flatten({"p": tp, "s": ts}))}
        _close(got, want, TOL.fwd, f"chunk {chunk} step {step}")
    assert opt._pieces(2 * 3, 12, 10, 24) == [
        (slice(i, i + 1), slice(r, min(r + 2, 12))) for i in range(6)
        for r in range(0, 12, 2)]
    assert opt._pieces(6, 12, 10, 250) == [(slice(0, 2), slice(0, 12)),
                                           (slice(2, 4), slice(0, 12)),
                                           (slice(4, 6), slice(0, 12))]


def test_clip_is_folded_without_copying_the_gradient():
    """``apply`` leaves the gradient it is handed as it was (the clip is
    folded into each leaf's update, no clipped tree is made), and gives
    what clipping the tree first gives."""
    for make in (opt.adamw, opt.adafactor):
        g = tree_map(torch.tensor, _af_tree(1))
        keep = tree_map(torch.clone, g)
        a = tree_map(torch.tensor, _af_tree(0))
        b = tree_map(torch.tensor, _af_tree(0))
        o = make(lr=1e-2, max_grad_norm=0.5)
        o.apply(g, o.init(a), a, 0)
        clipped, _ = opt.clip_by_global_norm(g, 0.5)
        plain = make(lr=1e-2, max_grad_norm=0.0)
        plain.apply(clipped, plain.init(b), b, 0)
        for x, y in zip(flatten(g)[1], flatten(keep)[1]):
            assert torch.equal(x, y)
        for x, y in zip(flatten(a)[1], flatten(b)[1]):
            assert torch.equal(x, y), make.__name__


def test_every_optimizer_takes_the_block_layout():
    """Every ``apply`` takes ``specs=``, ``rules=`` and ``shapes=``: a
    world of one's layout (no axis cuts a leaf) changes nothing, bit for
    bit; Adafactor handed specs without the whole leaves' shapes refuses
    rather than average over the block's count."""
    specs = tree_map(lambda x: (None,) * x.ndim, _af_tree(0))
    for make in (opt.adamw, opt.adafactor, opt.sgd):
        a = tree_map(torch.tensor, _af_tree(0))
        b = tree_map(torch.tensor, _af_tree(0))
        o = make(lr=1e-2)
        sa, sb = o.init(a), o.init(b)
        for step in range(2):
            g = tree_map(torch.tensor, _af_tree(step + 1))
            o.apply(g, sa, a, step)
            o.apply(g, sb, b, step, specs=specs, rules=None,
                    shapes=tree_map(torch.clone, b))
        for x, y in zip(flatten({"p": a, "s": sa})[1],
                        flatten({"p": b, "s": sb})[1]):
            assert torch.equal(x, y), make.__name__
    o = opt.adafactor(lr=1e-2)
    with pytest.raises(ValueError, match="shapes="):
        o.apply(g, o.init(a), a, 0, specs=specs, rules=None)


def test_adafactor_takes_a_leaf_whole_where_it_fits(monkeypatch):
    """On the card a leaf is updated whole where eight f32 copies of it
    fit in the free memory (CUDA's and the allocator's cache), so each u
    is computed once; else in chunks of ``ADAFACTOR_CHUNK``; on the CPU
    always in those chunks."""
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 5 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 4 << 30)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (31 << 30, 80 << 30))
    free = opt._free_bytes(torch.device("cuda", 0))
    assert free == 32 << 30
    assert opt._chunk_for(1 << 30, free) == 1 << 30
    assert opt._chunk_for(1 << 30, free - 1) == opt.ADAFACTOR_CHUNK
    assert opt._free_bytes(torch.device("cpu")) is None
    assert opt._chunk_for(1 << 10, None) == opt.ADAFACTOR_CHUNK


def _old_accumulate(model, params, batch, M):
    """``planner.accumulate`` as it summed before: into new tensors."""
    mb = batch["tokens"].shape[0] // M
    acc = None
    for i in range(M):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        _, _, g = planner.loss_and_grads(model, params, micro)
        g = flatten(g)[1]
        acc = ([x.float() for x in g] if acc is None
               else [a + x for a, x in zip(acc, g)])
    return [a / M for a in acc]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_place_accumulation_equals_the_old_sums(dtype):
    """The in-place sums and division give the bits the sums into new
    tensors gave, over 4 micro-batches (f32 sums of bf16 gradients
    too)."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype,
                              param_dtype=dtype)
    model = Model(cfg, "cpu")
    params = model.init(0)
    batch = {"tokens": torch.tensor(np.random.default_rng(1).integers(
        0, 512, (4, T)))}
    want = _old_accumulate(model, params, batch, 4)
    _, _, got = planner.accumulate(model, params, batch, 4)
    for x, y in zip(flatten(got)[1], want):
        assert x.dtype == torch.float32 and torch.equal(x, y)


@pytest.mark.parametrize("H,K", [(48, 8), (24, 4), (12, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_at_group_6_matches_reference(H, K, dtype):
    """Paged decode's plain version at grok's group of 6 (48/8 heads, a
    tp-2 rank's 24/4, the serving case's 12/2) against the reference's
    kernel in interpret mode; the CUDA wrapper takes the group."""
    D, ps, mp, Bq = 128, 8, 3, 3
    q, kp, vp, table, pos = paged_inputs(Bq, H, K, D, ps, mp, 1 + Bq * mp,
                                         seed=H)
    want = jax_paged(*(jnp.asarray(a, dtype) for a in (q, kp, vp)),
                     jnp.asarray(table), jnp.asarray(pos), interpret=True)
    tdt = getattr(torch, dtype)
    got = paged.paged_decode(*(torch.tensor(a).to(tdt) for a in (q, kp, vp)),
                             torch.tensor(table), torch.tensor(pos))
    assert got.dtype == tdt and got.shape == (Bq, H, D)
    close(got.float(), want, VTOL[dtype])
    assert 6 in paged.GROUPS


# ---------------------------------------------------------------------------
# the port on 4 gloo ranks
# ---------------------------------------------------------------------------

def _spy(o, seen: dict):
    real_apply = o.apply

    def apply(grads, state, p, step, **kw):
        if step == 0:
            seen["grads"] = tree_map(torch.clone, grads)
        return real_apply(grads, state, p, step, **kw)

    return dataclasses.replace(o, apply=apply)


def _dump(res: dict, prefix: str, tree) -> None:
    for path, v in zip(*flatten(tree)):
        res[f"{prefix}/{path}"] = v.detach().numpy()


def _train_case(name: str, d: dict, out_dir: str, res: dict,
                meta: dict, ckpts: dict) -> None:
    cfg = _cfg(get_config)
    model = Model(cfg, "cpu")
    strat = TRAIN[name]
    plan = planner.compile_plan(
        model, planner.mesh_for_strategy(strat, device_type="cpu"), strat)
    params = plan.shard(params_from_numpy(cfg, _tree(d, "params/"), "cpu"),
                        plan.param_specs)
    seen = {}
    o = _spy(opt.adafactor(lr=LR), seen)
    state = {"params": params, "opt": plan.init_opt(o, params)}
    step = plan.train_step_fn(o)
    batch = plan.batch_slice({"tokens": torch.tensor(d["tokens"])})
    losses = []
    for i in range(AF_STEPS):
        p, s, m = step(state["params"], state["opt"], batch, i)
        state = {"params": p, "opt": s}
        losses.append(float(m["loss"]))
    with sharding.use_rules(plan.rules):
        split, dim = moe._expert_split(model.cfg.moe_cfg())
    grads = tree_map(lambda g, s: sharding.gather_leaf(g, s, plan.rules),
                     seen["grads"], plan.param_specs)
    whole = plan.gather_state(state, o)
    ckpt = CheckpointManager(os.path.join(out_dir, f"ck_{name}"), keep=1,
                             rank=dist.get_rank(), barrier=dist.barrier,
                             gather=lambda tree: plan.gather_state(tree, o))
    ckpt.save(AF_STEPS, state)
    at, back, _ = plan.restore_state(ckpt, o)
    ckpts[name] = ckpt
    meta[name] = {
        "losses": losses, "split": [dim, split.n],
        "w_in": list(state["params"]["blocks"]["p0"]["moe"]["w_in"].shape),
        "line": plan.split_line(),
        "restored": at == AF_STEPS and all(
            torch.equal(a, b) for a, b in zip(flatten(back)[1],
                                              flatten(state)[1]))}
    if dist.get_rank() == 0:
        _dump(res, f"{name}/grads", grads)
        _dump(res, f"{name}/state", whole)


def _resume_case(d: dict, meta: dict, ckpts: dict) -> None:
    """ZeRO-3's checkpoint restored into ZeRO-1's plan: its next step."""
    cfg = _cfg(get_config)
    strat = TRAIN["zero1"]
    plan = planner.compile_plan(Model(cfg, "cpu"), planner.mesh_for_strategy(
        strat, device_type="cpu"), strat)
    o = opt.adafactor(lr=LR)
    at, st, _ = plan.restore_state(ckpts["zero3"], o)
    batch = plan.batch_slice({"tokens": torch.tensor(d["tokens"])})
    _, _, m = plan.train_step_fn(o)(st["params"], st["opt"], batch, at)
    meta["resumed"] = [at, float(m["loss"])]


def _pipe_case(d: dict, res: dict, meta: dict) -> None:
    cfg = _cfg(get_config)
    model = Model(cfg, "cpu")
    plan = planner.compile_plan(model, planner.mesh_for_strategy(
        PIPE, device_type="cpu"), PIPE)
    sl = plan.stage_layers()
    stage = plan.mesh.get_local_rank("stage")
    params = plan.shard(pipe.stage_state(params_from_numpy(
        cfg, _tree(d, "params/"), "cpu"), stage, sl),
        sharding.within_stage(plan.param_specs))
    o = opt.adafactor(lr=LR)
    state = o.init(params)
    step = plan.pipeline_train_step_fn(o)
    losses = []
    for i in range(AF_STEPS):
        params, state, m = step(params, state, torch.tensor(d["tokens"]), i)
        losses.append(float(m["loss"]))
    meta["pipeline"] = {"losses": losses, "line": plan.split_line()}
    whole = plan.gather_pipeline_state({"params": params, "opt": state}, o,
                                       sl)
    if dist.get_rank() == 0:             # even stages: the padded layout
        _dump(res, "pipeline/state", whole)  # is the standard one


def _serve_case(d: dict, res: dict, meta: dict) -> None:
    cfg = _serve_cfg(get_config)
    model = Model(cfg, "cpu")
    plan = planner.compile_plan(model, make_mesh((2, 2), ("data", "model"),
                                                 device_type="cpu"))
    params = model.serving_params(plan.shard(params_from_numpy(
        cfg, _tree(d, "s_params/"), "cpu"), plan.param_specs))
    meta["serve_w_in"] = list(params["blocks"]["p0"]["moe"]["w_in"].shape)
    lo, hi = plan.slot_block(SB)
    steps = torch.tensor(d["s_steps"]).long()
    logits, st = plan.prefill_fn(GB)(
        params, {"tokens": torch.tensor(d["s_tokens"])},
        last_idx=torch.tensor(LAST))
    res["prefill/logits"] = logits.numpy()
    specs = plan.state_specs(SB, SS + GB)
    whole = {"cache": {"p0": {k: torch.tensor(d[f"dense/{k}"])
                              for k in ("k", "v")}},
             "pos": torch.tensor(LAST, dtype=torch.int32) + 1}
    state = tree_map(lambda x, s: sharding.shard_leaf(x, s, plan.rules),
                     whole, specs)
    step = plan.serve_step_fn(SB, SS + GB)
    lg = []
    for t in range(STEPS):
        logits, state = step(params, steps[t, lo:hi], state)
        lg.append(plan.gather_slots(logits))
    res["dense/logits"] = torch.stack(lg).numpy()
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


def _rank_main(rank: int, store: str, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    d = dict(np.load(inputs))
    res, meta, ckpts = {}, {}, {}
    for name in TRAIN:
        _train_case(name, d, out_dir, res, meta, ckpts)
    _resume_case(d, meta, ckpts)
    _pipe_case(d, res, meta)
    _serve_case(d, res, meta)
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("grok")
    pools, table, pos = ref["paged_in"]
    np.savez(d / "inputs.npz", tokens=ref["tokens"], s_tokens=ref["s_tokens"],
             s_steps=ref["s_steps"], table=table, paged_pos=pos,
             **{f"params/{k}": v for k, v in ref["params"].items()},
             **{f"s_params/{k}": v for k, v in ref["s_params"].items()},
             **{f"pool/{k}": v for k, v in pools.items()},
             **{f"dense/{k}": v for k, v in ref["prefill", GB][1].items()})
    ctx = mp.start_processes(
        _rank_main, args=(str(d / "store"), str(d / "inputs.npz"), str(d)),
        nprocs=WORLD, join=False, start_method="spawn")
    for p in ctx.processes:
        p.join(240)
    alive = [p for p in ctx.processes if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank did not finish within 240 s"
    assert ctx.join(), "the ranks did not exit"
    metas = []
    for r in range(WORLD):
        with open(d / f"rank{r}.json") as f:
            metas.append(json.load(f))
    return dict(np.load(d / "rank0.npz")), metas


@pytest.mark.parametrize("name", list(TRAIN))
def test_expert_mlp_split_trains_as_reference(name, ranks, ref):
    """data 2 × model 2 with ZeRO 0, 1, 3 and Adafactor: the experts' d_ff
    split over model (each rank 32 of 64 columns of all 3 experts); the
    step-0 loss and every gathered gradient leaf against the reference's
    ``loss_fn`` on the whole batch; the losses of AF_STEPS steps, and the
    gathered parameters and factored moments after them, against its
    ``adafactor`` on the unsharded leaves; the checkpoint restored into
    the ranks' blocks bit for bit."""
    res, metas = ranks
    got = metas[0][name]["losses"]
    _fclose(got[0], ref["loss"])
    _close(_tree(res, f"{name}/grads/"), ref["grads"], TOL.grad,
           f"{name} gradients")
    _fclose(got, ref["whole", "losses"][:AF_STEPS])
    _close(_tree(res, f"{name}/state/"), ref["whole", "state"], TOL.grad,
           f"{name} state")
    for m in metas:
        assert m[name]["losses"] == got
        assert m[name]["split"] == ["expert_mlp", 2]
        assert m[name]["w_in"][1:] == [3, 128, 32]
        assert m[name]["restored"]
    assert "experts' d_ff columns" in metas[0][name]["line"]


def test_zero3_checkpoint_resumes_in_zero1(ranks, ref):
    """ZeRO-3's checkpoint (its factored moments gathered whole) restored
    into ZeRO-1's plan: the next step's loss is the reference's."""
    _, metas = ranks
    for m in metas:
        at, loss = m["resumed"]
        assert at == AF_STEPS
        _fclose(loss, ref["whole", "losses"][AF_STEPS])


def test_adafactor_through_pipeline_split_matches_reference(ranks, ref):
    """``pipeline{split}`` (stage 2 × model 2) with Adafactor: the losses
    and the gathered parameters after AF_STEPS steps against the
    reference's ``adafactor`` on the mean of its two micro-batches'
    gradients, and the factored moments gathered in the pipelined
    checkpoint's layout."""
    res, metas = ranks
    got = metas[0]["pipeline"]["losses"]
    _fclose(got, ref["micro", "losses"][:AF_STEPS])
    _close(_tree(res, "pipeline/state/"), ref["micro", "state"], TOL.grad,
           "pipeline{split}")
    assert all(m["pipeline"]["losses"] == got for m in metas)
    assert "pipeline×2" in metas[0]["pipeline"]["line"]


def test_expert_mlp_split_serves_as_reference(ranks, ref):
    """Serving at data 2 × model 2 with grok's group of 6 and the experts'
    d_ff split: prefill logits, teacher-forced dense steps (the cache's
    sequence over model) and paged steps against the reference's."""
    res, metas = ranks
    assert all(m["serve_w_in"][1:] == [3, 128, 32] for m in metas)
    _fclose(res["prefill/logits"], ref["prefill", GB][0])
    _fclose(res["dense/logits"], ref["dense"])
    _fclose(res["paged/logits"][:, :SB - 1], ref["paged"][:, :SB - 1])
