"""The rest of the dense family split over ``model`` (``split×2``) against
the reference's unmeshed ``loss_fn`` on the CPU.

One spawn of 2 gloo ranks (``torch.multiprocessing`` over a ``FileStore``
in ``tmp_path``) trains each case's ``SMOKE`` model in f32, remat
``full``, at tp 2 through ``ExecutionPlan.train_step_fn``:

- qwen3-1.7b with its 2 kv heads: the ``grouped`` layout, each rank's q
  and k normed by the whole ``q_norm``/``k_norm`` scales;
- qwen3-1.7b with 1 kv head: the ``repeat`` layout with qk-norm;
- gemma-2b (GeGLU, one kv head: ``repeat``, tied head);
- stablelm-3b (LayerNorm with biases, MHA: ``grouped``).

Each case's step-0 loss within 2e-5 and every gathered step-0 gradient
leaf within 2e-4 (tests/torch_harness.py) of the reference's
``jax.value_and_grad`` on the whole batch, with the weights crossed over
by ``models/convert.py``; the qk-norm scales lie whole on each rank and
norm its own heads, so their gradient is right only where it is summed
over the split once.  Then three AdamW steps' losses against the
reference's optimizer loop, equal on both ranks.
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

from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.models import lm as ref_lm
from repro.optim import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.models import attention
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro_torch.tree import flatten, tree_map

from torch_harness import TOLS

TOL = TOLS["float32"]
LR = 1e-3
B, T = 4, 32
STEPS = 3
WORLD = 2
#: name: (arch, kv heads (None: the smoke's), the layout at tp 2)
CASES = {
    "qwen3_grouped": ("qwen3-1.7b", None, "grouped"),
    "qwen3_repeat": ("qwen3-1.7b", 1, "repeat"),
    "gemma": ("gemma-2b", None, "repeat"),
    "stablelm": ("stablelm-3b", None, "grouped"),
}


def _cfg(get, name: str):
    arch, kv, _ = CASES[name]
    cfg = dataclasses.replace(get(arch, smoke=True), remat="full")
    return cfg if kv is None else dataclasses.replace(cfg, n_kv_heads=kv)


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def ref():
    """Per case: the reference's weights, its unmeshed loss and gradients
    on the whole batch, and the losses of three AdamW steps."""
    out = {}
    for name in CASES:
        jcfg = _cfg(jax_get_config, name)
        tokens = np.random.default_rng(0).integers(
            0, jcfg.vocab, (B, T)).astype(np.int32)
        jm = ref_lm.build(jcfg)
        params = jm.init(jax.random.key(0))
        grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
        batch = {"tokens": jnp.asarray(tokens)}
        (loss, _), g = grad_fn(params, batch)
        opt = jax_opt.adamw(lr=LR)
        p, st, losses = params, opt.init(params), []
        for i in range(STEPS):
            (l, _), gi = grad_fn(p, batch)
            p, st = opt.apply(gi, st, p, i)
            losses.append(float(l))
        out[name] = {"tokens": tokens, "params": _np(params),
                     "loss": float(loss), "grads": _np(g), "losses": losses}
    return out


# ---------------------------------------------------------------------------
# the port on 2 gloo ranks
# ---------------------------------------------------------------------------

def _case(name: str, params_np: dict, tokens: np.ndarray, res: dict,
          meta: dict) -> None:
    cfg = _cfg(get_config, name)
    model = Model(cfg, "cpu")
    strat = StrategySpec(dp=1, tp=WORLD)
    plan = planner.compile_plan(
        model, planner.mesh_for_strategy(strat, device_type="cpu"), strat)
    params = plan.shard(params_from_numpy(cfg, params_np, "cpu"),
                        plan.param_specs)
    seen = {}
    opt = adamw(lr=LR)
    real_apply = opt.apply

    def apply(grads, state, p, step, **kw):
        if step == 0:
            seen["grads"] = tree_map(torch.clone, grads)
        return real_apply(grads, state, p, step, **kw)

    opt = dataclasses.replace(opt, apply=apply)
    state = (params, plan.init_opt(opt, params))
    step = plan.train_step_fn(opt)
    mine = plan.batch_slice({"tokens": torch.tensor(tokens)})
    losses = []
    for i in range(STEPS):
        p, o, m = step(*state, mine, i)
        state = (p, o)
        losses.append(float(m["loss"]))
    grads = tree_map(lambda g, s: sharding.gather_leaf(g, s, plan.rules),
                     seen["grads"], plan.param_specs)
    with sharding.use_rules(plan.rules):
        layout = attention.choose_layout(model.cfg.attn_cfg())
    meta[name] = {"losses": losses, "layout": layout}
    if dist.get_rank() == 0:
        for path, v in zip(*flatten(grads)):
            res[f"{name}/{path}"] = v.detach().numpy()


def _rank_main(rank: int, store: str, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    d = dict(np.load(inputs))
    res, meta = {}, {}
    for name in CASES:
        pre = f"{name}/"
        _case(name, {k[len(pre):]: v for k, v in d.items()
                     if k.startswith(pre)}, d[f"tokens/{name}"], res, meta)
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("dense_tp")
    np.savez(d / "inputs.npz",
             **{f"tokens/{name}": r["tokens"] for name, r in ref.items()},
             **{f"{name}/{k}": v for name, r in ref.items()
                for k, v in r["params"].items()})
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


@pytest.mark.parametrize("name", list(CASES))
def test_split_step_matches_reference(name, ranks, ref):
    """The step-0 loss and every gathered step-0 gradient leaf (the
    qk-norm scales and LayerNorm biases included) against the reference's
    unmeshed ``loss_fn``; three AdamW steps' losses against its optimizer
    loop; both ranks report the same losses, in the expected layout."""
    res, metas = ranks
    want = ref[name]
    got = metas[0][name]["losses"]
    np.testing.assert_allclose(got[0], want["loss"], atol=TOL.fwd,
                               rtol=TOL.fwd)
    pre = f"{name}/"
    grads = {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}
    assert sorted(grads) == sorted(want["grads"])
    for path, w in want["grads"].items():
        np.testing.assert_allclose(grads[path], w, atol=TOL.grad,
                                   rtol=TOL.grad, err_msg=f"{name} {path}")
    np.testing.assert_allclose(got, want["losses"], atol=TOL.fwd,
                               rtol=TOL.fwd)
    assert all(m[name]["losses"] == got for m in metas)
    assert metas[0][name]["layout"] == CASES[name][2]


def test_cases_cover_the_whole_leaves_a_split_must_sum():
    """The cases hold the leaves that lie whole on each rank of a head
    split: qk-norm's scales in both layouts (their gradient comes from
    the rank's own heads alone), and the LayerNorm biases."""
    paths = {name: set(flatten(Model(_cfg(get_config, name), "meta").init(
        0))[0]) for name in CASES}
    for name in ("qwen3_grouped", "qwen3_repeat"):
        assert {"blocks/p0/attn/q_norm/scale",
                "blocks/p0/attn/k_norm/scale"} <= paths[name]
    assert {"blocks/p0/norm1/bias", "blocks/p0/norm2/bias",
            "final_norm/bias"} <= paths["stablelm"]
