"""The rest of the dense family in the port — qwen3-1.7b (per-head
qk-norm, tied head), gemma-2b (GeGLU, MQA, tied 256k head) and
stablelm-3b (LayerNorm, MHA) — against the reference (``repro.models``)
on the CPU: each ``SMOKE`` config with the reference's ``Model.init``
weights crossed over by ``params_from_numpy``, the same numpy tokens.
Tolerances (tests/torch_harness.py): f32 values 2e-5, gradients and the
driver's losses 2e-4.

- the parameter tree leaf for leaf (``q_norm``/``k_norm``, the LayerNorm
  biases, no ``wg`` where the MLP is ungated);
- prefill logits and the KV cache with ragged ``last_idx``, then four
  greedy ``serve_step``s (logits and argmax tokens), and three
  ``serve_step_paged`` steps over pools built from one prefill;
- ``loss_fn`` and every gradient leaf under remat none and full;
- three AdamW steps of ``launch/train.py`` resumed from the reference's
  step-0 checkpoint against the reference's loop;
- the parameter specs at model 2 (``repeat`` for gemma's one kv head)
  with ``==`` against the reference's rules on an ``AbstractMesh``;
- the layers alone: LayerNorm, the activation table (gelu is the tanh
  approximation) and the ungated MLP; ``moe_block`` with GeGLU experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.core import planner as ref_planner
from repro.core.cost_model import StrategySpec as RefStrategySpec
from repro.data import pipeline as jax_pipeline
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.optim import optimizer as jax_opt
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.launch import train
from repro_torch.models import layers, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.tree import flatten

from torch_harness import TOLS

ARCHS = ("qwen3-1.7b", "gemma-2b", "stablelm-3b")
TOL = TOLS["float32"]
B, T = 4, 16                      # the smoke model's loss batch
STEPS = 3                         # the driver's AdamW steps


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


def _close(got, want, tol=TOL.fwd, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _driver_reference(arch: str, batch: int = 2, seq: int = 32):
    """(initial params, opt state, data state) and the losses of the
    reference's loop with the driver's schedule and data stream."""
    jcfg = jax_get_config(arch, smoke=True)
    jm = ref_lm.build(jcfg)
    params = jm.init(jax.random.key(0))
    sched = jax_opt.Schedule(base_lr=3e-4, warmup=min(100, STEPS // 10 + 1),
                             decay_steps=STEPS)
    o = jax_opt.adamw(lr=sched)
    state = o.init(params)
    data = jax_pipeline.TokenPipeline(
        jax_pipeline.DataCfg(global_batch=batch, seq_len=seq,
                             vocab=jcfg.vocab, seed=0), host_id=0, n_hosts=1)
    init = (params, state, data.state_dict())
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    apply = jax.jit(o.apply)
    losses = []
    for i in range(STEPS):
        (loss, _), g = grad_fn(params,
                               {"tokens": jnp.asarray(
                                   data.next_batch()["tokens"])})
        params, state = apply(g, state, params, i)
        losses.append(float(loss))
    return init, losses


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """One arch's reference: smoke weights (numpy and JAX), tokens, the
    unmeshed loss, metrics and gradients, and the driver's loop."""
    arch = request.param
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               remat="none")
    jm = ref_lm.build(jcfg)
    params = jax.jit(jm.init)(jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (B, T)).astype(
        np.int32)
    (loss, m), g = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        params, {"tokens": jnp.asarray(tokens)})
    return {"arch": arch, "jm": jm, "jp": params, "params": _np(params),
            "tokens": tokens,
            "whole": (float(loss), {k: float(v) for k, v in m.items()},
                      _np(g)),
            "driver": _driver_reference(arch)}


def _port(smoke, remat="none", **kw):
    cfg = dataclasses.replace(get_config(smoke["arch"], smoke=True),
                              remat=remat, **kw)
    return Model(cfg, "cpu"), params_from_numpy(cfg, smoke["params"], "cpu")


def test_the_three_configs_are_registered_as_the_reference_has_them():
    for arch in ARCHS:
        assert arch in ARCH_NAMES
        for smoke in (False, True):
            ours, ref = get_config(arch, smoke), jax_get_config(arch, smoke)
            for f in dataclasses.fields(ours):
                assert getattr(ours, f.name) == getattr(ref, f.name), \
                    (arch, smoke, f.name)
    assert get_config("gemma-2b", smoke=True).n_kv_heads == 1


def test_params_cross_leaf_for_leaf(smoke):
    model, params = _port(smoke)
    got = dict(zip(*flatten(params)))
    assert sorted(got) == sorted(smoke["params"])
    for path, w in smoke["params"].items():
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)
    cfg = model.cfg
    attn = params["blocks"]["p0"]["attn"]
    assert ("q_norm" in attn) == ("k_norm" in attn) == cfg.qk_norm
    assert ("bias" in params["final_norm"]) == (cfg.norm == "ln")
    assert ("head" in params) != cfg.tie_embeddings
    # the port's own init draws the same tree
    shapes = {p: (tuple(t.shape), t.dtype) for p, t in
              zip(*flatten(model.init(1)))}
    assert shapes == {p: (tuple(t.shape), t.dtype) for p, t in got.items()}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_leaf_match_reference(smoke, remat):
    model, params = _port(smoke, remat)
    for v in flatten(params)[1]:
        v.requires_grad_(True)
    loss, m = model.loss_fn(params, {"tokens": torch.tensor(smoke["tokens"])})
    want_loss, want_m, want_g = smoke["whole"]
    np.testing.assert_allclose(loss.item(), want_loss, atol=TOL.fwd,
                               rtol=TOL.fwd)
    for k, v in want_m.items():
        np.testing.assert_allclose(m[k].item(), v, atol=TOL.fwd,
                                   rtol=TOL.fwd, err_msg=k)
    loss.backward()
    got = dict(zip(*flatten(params)))
    assert sorted(got) == sorted(want_g)
    for path, w in want_g.items():
        _close(got[path].grad, w, TOL.grad, path)


def test_prefill_and_decode_match_reference(smoke):
    """Prefill (ragged ``last_idx``) logits and the KV cache, then 4
    greedy ``serve_step``s, each step's logits and argmax tokens equal."""
    jm, jp = smoke["jm"], smoke["jp"]
    tm, tp = _port(smoke)
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
        for key in ("k", "v"):
            _close(st["cache"]["p0"][key], jst["cache"]["p0"][key])


def test_serve_step_paged_matches_reference(smoke):
    """The paged decode against the reference's over the same pools built
    from one prefill: logits of 3 steps and the pools after them."""
    jm, jp = smoke["jm"], smoke["jp"]
    tm, tp = _port(smoke)
    ps, mp, P = 4, 8, 13
    with torch.no_grad():
        _, st = tm.prefill(tp, {"tokens": torch.tensor(smoke["tokens"][:2])},
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


def test_train_driver_three_adamw_steps_match_reference(smoke, tmp_path):
    """``launch/train.py`` resumed from the reference's step-0 checkpoint:
    its three AdamW losses against the reference's loop."""
    (params, state, data_state), want = smoke["driver"]
    JaxCheckpointManager(str(tmp_path)).save(
        0, {"params": params, "opt": state}, extra={"data": data_state})
    out = train.main(["--arch", smoke["arch"], "--smoke", "--device", "cpu",
                      "--steps", str(STEPS), "--batch", "2", "--seq", "32",
                      "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == STEPS
    np.testing.assert_allclose(out["losses"], want, atol=TOL.grad,
                               rtol=TOL.grad)


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("zero", [0, 3])
def test_param_specs_at_model_2_equal_reference(arch, zero):
    """Every leaf's spec at model 2 (data 2 x model 2 under ZeRO-3), the
    qk-norm scales and LayerNorm biases included, with ``==``."""
    shape = {"data": 1 + (zero == 3), "model": 2}
    kw = dict(dp=shape["data"], tp=2, zero=zero, vocab_split=True)
    ref = ref_planner.compile_plan(
        ref_lm.build(jax_get_config(arch)),
        AbstractMesh(tuple(shape.values()), tuple(shape)),
        RefStrategySpec(**kw))
    strat = StrategySpec(**kw)
    ours = planner.ExecutionPlan(
        model=Model(get_config(arch), "meta"), mesh=None, strategy=strat,
        rules=sharding.rules_for_strategy(shape, strat))
    assert _specs(ours.param_specs) == _specs(ref.param_specs)


# ---------------------------------------------------------------------------
# the layers alone
# ---------------------------------------------------------------------------

def test_layernorm_and_activation_table_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(40).astype(np.float32),
         "bias": rng.standard_normal(40).astype(np.float32)}
    want = ref_layers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(layers.layernorm({k: torch.tensor(v) for k, v in p.items()},
                            torch.tensor(x)), want)
    for act in ("silu", "gelu", "relu"):
        _close(layers.ACTS[act](torch.tensor(x)),
               ref_layers._ACTS[act](jnp.asarray(x)), msg=act)
    # gelu is the tanh approximation: the exact erf form differs
    exact = torch.nn.functional.gelu(torch.tensor(x))
    assert float((exact - layers.ACTS["gelu"](torch.tensor(x))).abs().max()) \
        > 1e-4
    with pytest.raises(ValueError, match="unknown norm"):
        layers.make_norm("batch")


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_matches_reference(gated, act):
    rng = np.random.default_rng(8)
    f = lambda *s: rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0])
    p = {"wi": f(24, 48), "wo": f(48, 24)}
    if gated:
        p["wg"] = f(24, 48)
    x = rng.standard_normal((2, 6, 24)).astype(np.float32)
    want = ref_layers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          act=act)
    _close(layers.mlp({k: torch.tensor(v) for k, v in p.items()},
                      torch.tensor(x), act=act), want)
    assert sorted(layers.axes_mlp(gated)) == sorted(ref_layers.axes_mlp(
        gated))


def test_moe_block_with_geglu_experts_matches_reference():
    """``moe_block`` with ``act="gelu"`` (routed and shared experts) against
    the reference's: output, aux losses and the input's gradient."""
    D, E, K, FF = 32, 8, 2, 16
    kw = dict(d_model=D, n_experts=E, top_k=K, d_ff_expert=FF, n_shared=1,
              capacity_factor=1.25, act="gelu")
    rcfg, cfg = ref_moe.MoECfg(**kw), moe.MoECfg(**kw)
    rng = np.random.default_rng(9)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"router": {"w": f(D, E) / np.sqrt(D)},
         "w_in": f(E, D, FF) / np.sqrt(D), "w_gate": f(E, D, FF) / np.sqrt(D),
         "w_out": f(E, FF, D) / np.sqrt(FF),
         "shared": {"wi": f(D, FF) / np.sqrt(D), "wg": f(D, FF) / np.sqrt(D),
                    "wo": f(FF, D) / np.sqrt(FF)}}
    x, ct = f(4, 64, D), f(4, 64, D)

    def ref_fn(p, x):
        y, aux = ref_moe.moe_block(p, x, rcfg)
        return y, aux["lb_loss"], aux["z_loss"]

    (y, lb, z), vjp = jax.vjp(ref_fn, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x))
    _, gx = vjp((jnp.asarray(ct), jnp.float32(1.0), jnp.float32(1.0)))
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), p)
    tx = torch.tensor(x, requires_grad=True)
    ty, aux = moe.moe_block(tp, tx, cfg)
    _close(ty, y)
    np.testing.assert_allclose(aux["lb_loss"].item(), float(lb),
                               atol=TOL.fwd, rtol=TOL.fwd)
    np.testing.assert_allclose(aux["z_loss"].item(), float(z), atol=TOL.fwd,
                               rtol=TOL.fwd)
    ((ty * torch.tensor(ct)).sum() + aux["lb_loss"]
     + aux["z_loss"]).backward()
    _close(tx.grad, gx, TOL.grad)
