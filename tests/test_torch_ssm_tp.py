"""mamba2 over a model axis in the port (the SSD mixer's ``ssm_heads``
split, ``repro_torch.models.mamba2``) against the reference (``repro``) and
the port's own unsharded model, on the CPU.

One spawn of 2 gloo ranks (``torch.multiprocessing`` over a ``FileStore``
in ``tmp_path``) runs every case on the smoke mamba2 in f32 (2 layers, 8
SSD heads of 32, so 4 a rank at tp 2; the tied 512-row table, 256 rows a
rank under the vocab split):

- training at ``model 2``, both loss heads, with and without a
  ``loss_mask``: the step-0 loss within 2e-5 and every gathered step-0
  gradient leaf within 2e-4 of the reference's *unmeshed* ``loss_fn``
  (the weights carried across by ``models/convert.py``), and three AdamW
  steps' losses against the reference's loop;
- ZeRO 1 and 3 at ``data 2`` bit for bit against ZeRO 0: losses, and
  every gathered parameter and moment after three steps;
- serving at ``model 2``: the prefill's logits against the reference's
  and the unsharded port's, its state (``h`` and ``conv``, gathered over
  the heads) and four decode steps' logits against the unsharded port's,
  within 2e-5; ``Server(model, plan)``'s greedy tokens equal to the
  unsharded ``Server``'s;
- a planted fault: the gated norm's all-reduce of its sum of squares
  removed (``mamba2.sum_over_heads`` made the identity), which the loss
  and the logits must show beyond their tolerance.

Then both drivers under ``torchrun`` with ``--mesh 1x2``: ``serve`` gives
the unsharded run's tokens, ``train`` its losses.
"""
import dataclasses
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
from repro.models.lm import Model as JaxModel
from repro.optim import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.launch import serve, train
from repro_torch.models import mamba2
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro_torch.serving.server import Request, Server
from repro_torch.tree import flatten, tree_map

from torch_harness import TOLS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mamba2-1.3b"
TOL = TOLS["float32"]
LR = 1e-3
B, T = 2, 64                     # training batch: two chunks of 32 a row
STEPS = 3
WORLD = 2
SB, SS = 2, 32                   # serving: prefill batch and bucket
LAST = [20, 31]
DECODE = 4                       # teacher-forced decode steps
GEN_BUDGET = 8
SPEC = [(9, 6), (30, 5), (17, 7)]   # Server requests: (prompt, new tokens)
#: name: ((data, model) mesh, zero, loss head, masked)
CASES = {
    "tp2": ((1, 2), 0, "chunked", False),
    "tp2_fused_masked": ((1, 2), 0, "fused", True),
    "dp2": ((2, 1), 0, "chunked", False),
    "dp2_zero1": ((2, 1), 1, "chunked", False),
    "dp2_zero3": ((2, 1), 3, "chunked", False),
}


def _cfg(get, remat: str = "full"):
    return dataclasses.replace(get(ARCH, smoke=True), remat=remat)


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


def _drive(server, params, prompts) -> dict:
    """Every request of SPEC through ``server``: {rid: tokens}."""
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
    else:
        raise AssertionError("drive did not converge")
    return {str(r.rid): [int(t) for t in r.out_tokens] for r in done}


def _unsharded_serving(cfg, full: dict, d: dict) -> dict:
    """The port's unsharded prefill (logits, state), decode steps and
    Server tokens: the split's yardstick (tests/test_torch_ssm.py holds
    this model against the reference)."""
    model = Model(cfg, "cpu")
    params = model.serving_params(full)
    out = {}
    with torch.no_grad():
        logits, st = model.prefill(params, {"tokens": torch.tensor(
            d["serve_tokens"])}, GEN_BUDGET, torch.tensor(LAST))
        out["prefill/logits"] = logits.numpy()
        for k, v in st["cache"]["p0"].items():
            out[f"prefill/{k}"] = v.numpy().copy()
        lg = []
        for t in range(DECODE):
            logits, st = model.serve_step(params, torch.tensor(
                d["decode"][t]).long(), st)
            lg.append(logits)
        out["decode/logits"] = torch.stack(lg).numpy()
    prompts = [d[f"prompt{i}"] for i in range(len(SPEC))]
    out["tokens"] = _drive(Server(model, None, batch_slots=2, max_len=64),
                           params, prompts)
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference's unmeshed loss, gradients and AdamW steps on the
    whole batch, with and without a mask; its prefill logits; the inputs."""
    jm = JaxModel(_cfg(jax_get_config))
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    V = jm.cfg.vocab
    out = {"params": _np(params),
           "tokens": rng.integers(0, V, (B, T)).astype(np.int32),
           "mask": (rng.random((B, T)) < 0.7).astype(np.float32),
           "serve_tokens": rng.integers(0, V, (SB, SS)).astype(np.int32),
           "decode": rng.integers(0, V, (DECODE, SB)).astype(np.int32)}
    for i, (n, _) in enumerate(SPEC):
        out[f"prompt{i}"] = rng.integers(0, V, n).astype(np.int32)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    for masked in (False, True):
        batch = {"tokens": jnp.asarray(out["tokens"])}
        if masked:
            batch["loss_mask"] = jnp.asarray(out["mask"])
        (loss, _), g = grad_fn(params, batch)
        out[masked] = (float(loss), _np(g))
        opt = jax_opt.adamw(lr=LR)
        p, st, losses = params, opt.init(params), []
        for i in range(STEPS):
            (loss, _), g = grad_fn(p, batch)
            p, st = opt.apply(g, st, p, i)
            losses.append(float(loss))
        out[masked, "losses"] = losses
    logits, _ = jm.prefill(params,
                           {"tokens": jnp.asarray(out["serve_tokens"])},
                           gen_budget=GEN_BUDGET, last_idx=jnp.asarray(LAST))
    out["prefill_logits"] = np.asarray(logits)
    return out


# ---------------------------------------------------------------------------
# the port on 2 gloo ranks
# ---------------------------------------------------------------------------

def _plan(model, shape, zero=0):
    strat = StrategySpec(dp=shape[0], tp=shape[1], zero=zero)
    return planner.compile_plan(model, planner.mesh_for_strategy(
        strat, device_type="cpu"), strat)


def _train_case(name, full, batch, res, meta) -> None:
    shape, zero, head, masked = CASES[name]
    model = Model(_cfg(get_config), "cpu", xent_impl=head)
    plan = _plan(model, shape, zero)
    params = plan.shard(tree_map(torch.clone, full), plan.param_specs)
    seen = {}
    opt = adamw(lr=LR)
    real_apply = opt.apply

    def apply(grads, state, p, step, **kw):
        if step == 0:
            seen["grads"] = tree_map(torch.clone, grads)
        return real_apply(grads, state, p, step, **kw)

    opt = dataclasses.replace(opt, apply=apply)
    state = {"params": params, "opt": plan.init_opt(opt, params)}
    step = plan.train_step_fn(opt)
    mine = plan.batch_slice(batch if masked else {"tokens": batch["tokens"]})
    losses = []
    for i in range(STEPS):
        p, o, m = step(state["params"], state["opt"], mine, i)
        state = {"params": p, "opt": o}
        losses.append(float(m["loss"]))
    meta[name] = {"losses": losses,
                  "split": {path: list(v.shape)
                            for path, v in zip(*flatten(params))}}
    grads = tree_map(lambda g, s: sharding.gather_leaf(g, s, plan.rules),
                     seen["grads"], plan.param_specs)
    whole = plan.gather_state(state, opt)
    if dist.get_rank() == 0:
        for path, v in zip(*flatten(grads)):
            res[f"{name}/grads/{path}"] = v.detach().numpy()
        for path, v in zip(*flatten(whole)):
            res[f"{name}/state/{path}"] = v.detach().numpy()


def _serve(model, plan, params, d, res, tag: str) -> None:
    """The split's prefill (logits, state gathered over the heads) and
    decode steps under ``plan``."""
    specs = plan.state_specs(SB, SS + GEN_BUDGET)["cache"]["p0"]
    logits, st = plan.prefill_fn(GEN_BUDGET)(
        params, {"tokens": torch.tensor(d["serve_tokens"])},
        last_idx=torch.tensor(LAST))
    res[f"{tag}/prefill/logits"] = logits.numpy()
    for k, v in st["cache"]["p0"].items():
        res[f"{tag}/prefill/{k}"] = sharding.gather_leaf(
            v, specs[k], plan.rules).numpy().copy()
    step = plan.serve_step_fn(SB, SS + GEN_BUDGET)
    lg = []
    for t in range(DECODE):
        logits, st = step(params, torch.tensor(d["decode"][t]).long(), st)
        lg.append(logits)
    res[f"{tag}/decode/logits"] = torch.stack(lg).numpy()


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    d = dict(np.load(inputs))
    cfg = _cfg(get_config)
    full = params_from_numpy(cfg, {k[2:]: v for k, v in d.items()
                                   if k.startswith("p/")}, "cpu")
    batch = {"tokens": torch.tensor(d["tokens"]),
             "loss_mask": torch.tensor(d["mask"])}
    res, meta = {}, {}
    for name in CASES:
        _train_case(name, full, batch, res, meta)

    model = Model(cfg, "cpu")
    plan = _plan(model, (1, 2))
    params = model.serving_params(plan.shard(full, plan.param_specs))
    _serve(model, plan, params, d, res, "split")
    prompts = [d[f"prompt{i}"] for i in range(len(SPEC))]
    meta["tokens"] = _drive(Server(model, plan, batch_slots=2, max_len=64),
                            params, prompts)
    meta["state_shape"] = {
        k: list(v.shape) for k, v in plan.local_zeros(
            model.decode_state_shapes(SB, 64),
            plan.state_specs(SB, 64))["cache"]["p0"].items()}

    # the planted fault: the gated norm over this rank's heads alone
    real = mamba2.sum_over_heads
    mamba2.sum_over_heads = lambda t, split: t
    try:
        _serve(model, plan, params, d, res, "planted")
        with sharding.use_rules(plan.rules), torch.no_grad():
            loss, _ = model.loss_fn(plan.shard(full, plan.param_specs),
                                    {"tokens": batch["tokens"]})
        meta["planted_loss"] = float(loss)
    finally:
        mamba2.sum_over_heads = real
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("ssm_tp")
    arrays = {k: ref[k] for k in ("tokens", "mask", "serve_tokens",
                                  "decode")}
    arrays.update({f"prompt{i}": ref[f"prompt{i}"] for i in range(len(SPEC))})
    arrays.update({f"p/{k}": v for k, v in ref["params"].items()})
    np.savez(d / "inputs.npz", **arrays)
    ctx = mp.start_processes(
        _rank_main, args=(WORLD, str(d / "store"), str(d / "inputs.npz"),
                          str(d)), nprocs=WORLD, join=False,
        start_method="spawn")
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
    cfg = _cfg(get_config)
    unsharded = _unsharded_serving(
        cfg, params_from_numpy(cfg, ref["params"], "cpu"), arrays)
    return dict(np.load(d / "rank0.npz")), metas, unsharded


def _tree(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


@pytest.mark.parametrize("name", ["tp2", "tp2_fused_masked", "dp2"])
def test_split_step_matches_reference(name, ranks, ref):
    """The step-0 loss and every gathered step-0 gradient leaf against the
    reference's unmeshed ``loss_fn``; three AdamW steps' losses against
    its loop; every rank reports the same losses."""
    res, metas, _ = ranks
    masked = CASES[name][3]
    want_loss, want_g = ref[masked]
    got = metas[0][name]["losses"]
    _close(got[0], want_loss, TOL.fwd)
    grads = _tree(res, f"{name}/grads/")
    assert sorted(grads) == sorted(want_g)
    for path, w in want_g.items():
        _close(grads[path], w, TOL.grad, f"{name} {path}")
    _close(got, ref[masked, "losses"], TOL.fwd)
    assert all(m[name]["losses"] == got for m in metas)


def test_each_rank_holds_its_heads(ranks):
    """At tp 2 the heads' leaves are halves, ``wB``/``wC`` whole, the
    table's rows (the tied head's columns) halves; ZeRO-3 also halves a
    dim over data."""
    _, metas, _ = ranks
    tp2 = metas[0]["tp2"]["split"]
    assert tp2["blocks/p0/ssd/wz"] == [2, 128, 4, 32]
    assert tp2["blocks/p0/ssd/wo"] == [2, 4, 32, 128]
    assert tp2["blocks/p0/ssd/conv_x"] == [2, 4, 32, 4]
    assert tp2["blocks/p0/ssd/A_log"] == [2, 4]
    assert tp2["blocks/p0/ssd/norm_scale"] == [2, 4, 32]
    assert tp2["blocks/p0/ssd/wB"] == [2, 128, 1, 16]
    assert tp2["embed/table"] == [256, 128]
    z3 = metas[0]["dp2_zero3"]["split"]
    # a model axis of one still claims its dims: the table's embed dim and
    # wz's embed dim take data
    assert z3["embed/table"] == [512, 64] and z3["blocks/p0/ssd/wz"] == [
        2, 64, 8, 32]
    assert metas[0]["state_shape"] == {"h": [2, 2, 4, 32, 16],
                                       "conv": [2, 2, 3, 4, 32]}


@pytest.mark.parametrize("zero", ["dp2_zero1", "dp2_zero3"])
def test_zero_equals_zero0_bit_for_bit(ranks, zero):
    """ZeRO-1 and ZeRO-3 over the ssm family equal ZeRO-0 bit for bit:
    losses, step-0 gradients, and every parameter and moment after three
    steps."""
    res, metas, _ = ranks
    assert metas[0][zero]["losses"] == metas[0]["dp2"]["losses"]
    for part in ("grads", "state"):
        want, got = _tree(res, f"dp2/{part}/"), _tree(res, f"{zero}/{part}/")
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=f"{zero} {path}")


def test_prefill_matches_reference_and_unsharded(ranks, ref):
    res, _, one = ranks
    _close(res["split/prefill/logits"], ref["prefill_logits"], TOL.fwd)
    for key in ("logits", "h", "conv"):
        _close(res[f"split/prefill/{key}"], one[f"prefill/{key}"], TOL.fwd,
               key)


def test_decode_steps_match_unsharded(ranks):
    res, _, one = ranks
    _close(res["split/decode/logits"], one["decode/logits"], TOL.fwd)


def test_server_tokens_equal_unsharded(ranks):
    _, metas, one = ranks
    assert len(one["tokens"]) == len(SPEC)
    for m in metas:
        assert m["tokens"] == one["tokens"]


def test_gated_norm_without_its_all_reduce_fails(ranks, ref):
    """The gated norm over this rank's heads alone (the all-reduce of its
    sum of squares removed): the logits and the loss leave their
    tolerance, so the checks above would catch it."""
    res, metas, one = ranks
    for key in ("prefill/logits", "decode/logits"):
        with pytest.raises(AssertionError):
            _close(res[f"planted/{key}"], one[key], TOL.fwd)
    assert abs(metas[0]["planted_loss"] - ref[False][0]) > 10 * TOL.fwd


# ---------------------------------------------------------------------------
# the drivers under torchrun (2 gloo ranks)
# ---------------------------------------------------------------------------

def _torchrun(module: str, argv: list, cwd) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", module] + argv,
        capture_output=True, text=True, timeout=300, env=env, cwd=str(cwd))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    return p.stdout


def test_serve_driver_over_model_gives_the_unsharded_tokens(tmp_path):
    """``serve --arch mamba2-1.3b --mesh 1x2`` completes every request
    with the unsharded run's tokens (their CRC-32)."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--cache",
            "dense", "--requests", "4", "--batch-slots", "2",
            "--prompt-len", "20", "--gen", "6", "--max-len", "64"]
    want = serve.main(argv)
    out = _torchrun("repro_torch.launch.serve", argv + ["--mesh", "1x2"],
                    tmp_path)
    assert "split×2 over model (SSD heads, vocab)" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve/")]
    assert len(lines) == 1 and "4 requests completed" in lines[0]
    assert f"tokens crc32 {want['tokens_crc32']:08x})" in lines[0]


def test_train_driver_over_model_matches_one_device(tmp_path):
    """``train --arch mamba2-1.3b --mesh 1x2`` prints the losses of the
    run on one device (to the 4 decimals it prints)."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "64", "--log-every", "1"]
    one = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])["losses"]
    out = _torchrun("repro_torch.launch.train", argv + [
        "--mesh", "1x2", "--ckpt-dir", str(tmp_path / "tp")], tmp_path)
    assert "split×2 over model (SSD heads, vocab)" in out
    got = [float(line.split()[3]) for line in out.splitlines()
           if line.strip().startswith("step ")]
    np.testing.assert_allclose(got, one, atol=TOL.grad + 5e-5, rtol=0)
