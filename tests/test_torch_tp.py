"""The port's tensor parallelism and ZeRO (``repro_torch.core.planner``
over ``core/sharding.py``) against the reference (``repro``) on the CPU.

One spawn of 4 gloo ranks (``torch.multiprocessing`` over a ``FileStore``
in ``tmp_path``) runs every sharded case: the smoke tinyllama in f32 with
the vocab cut to 500 (padded to 512, so the last vocab shard holds
padding columns) and remat ``full`` (ZeRO-3 gathers inside each repeat's
checkpoint), on ``model 4`` and ``data 2 × model 2`` meshes.  With 2 kv
heads the attention is ``grouped`` at tp 2 and ``repeat`` at tp 4; with
the smoke's 1 kv head it is ``repeat`` at tp 2.  Both loss heads run: the
chunked vocab-parallel one and the vocab-shard Function over the plain
kernels, with and without a ``loss_mask``.  Each case is held against the
reference's *unmeshed* ``loss_fn`` under ``jax.value_and_grad`` on the
whole batch (the weights cross over through ``models/convert.py``): the
step-0 loss within 2e-5 and every gathered step-0 gradient leaf within
2e-4 (tests/torch_harness.py), and the losses of three AdamW steps
against the reference's optimizer loop.  ZeRO-1 equals ZeRO-0 bit for bit
(losses, parameters and the gathered moments), and so does ZeRO-3
without a mask (with one, within f32's tolerance).  Checkpoints: the
sharded start writes the unsharded run's files byte for byte, ZeRO-1's
last step ZeRO-0's, and each restores into the rank's shards.  Then the
driver under ``torchrun`` on 4 gloo ranks: ``--mesh 2x2`` trains and
resumes, and ``--auto`` trains the ``replica×2{split×2}`` it picks for
the 3-layer smoke model at batch 2.
"""
import dataclasses
import functools
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

from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.models import lm as ref_lm
from repro.optim import optimizer as jax_opt
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.models import attention
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro_torch.tree import flatten, tree_map

from torch_harness import TOLS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
TOL = TOLS["float32"]
LR = 1e-3
B, T = 4, 32
STEPS = 3
WORLD = 4
#: the two models: kv heads 2 (grouped at tp 2) and the smoke's 1
KV = {"A": 2, "B": 1}
#: name: (model, (data, model) mesh, zero, loss head, masked)
CASES = {
    "tp4": ("A", (1, 4), 0, "chunked", False),
    "tp4_fused_masked": ("A", (1, 4), 0, "fused", True),
    "tp2": ("A", (2, 2), 0, "chunked", True),
    "tp2_fused": ("A", (2, 2), 0, "fused", False),
    "repeat": ("B", (2, 2), 0, "chunked", False),
    "repeat_fused_masked": ("B", (2, 2), 0, "fused", True),
    "zero1": ("A", (2, 2), 1, "chunked", True),
    "zero3": ("A", (2, 2), 3, "chunked", True),
    "zero3_fused": ("A", (2, 2), 3, "fused", False),
    # the backward on a thread of its own, as the autograd engine runs it
    # on the card: a checkpoint's recompute must find the rules there too
    "tp2_backward_thread": ("A", (2, 2), 0, "chunked", True),
}
#: the cases whose checkpoints are written (at the start and the end)
CKPT = ("tp2", "zero1", "zero3")


def _cfg(get, kv: int):
    return dataclasses.replace(get(ARCH, smoke=True), n_kv_heads=kv,
                               vocab=500, remat="full")


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def ref():
    """The reference's unmeshed loss, gradients and three AdamW steps on
    the whole batch, per model and mask."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 500, (B, T)).astype(np.int32)
    mask = (np.random.default_rng(1).random((B, T)) < 0.7).astype(
        np.float32)
    out = {"tokens": tokens, "mask": mask}
    for key, kv in KV.items():
        jm = ref_lm.build(_cfg(jax_get_config, kv))
        params = jm.init(jax.random.key(0))
        out[key, "params"] = _np(params)
        grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
        for masked in (False, True):
            batch = {"tokens": jnp.asarray(tokens)}
            if masked:
                batch["loss_mask"] = jnp.asarray(mask)
            (loss, _), g = grad_fn(params, batch)
            out[key, masked] = (float(loss), _np(g))
            opt = jax_opt.adamw(lr=LR)
            p, st, losses = params, opt.init(params), []
            for i in range(STEPS):
                (loss, _), g = grad_fn(p, batch)
                p, st = opt.apply(g, st, p, i)
                losses.append(float(loss))
            out[key, masked, "losses"] = losses
    return out


# ---------------------------------------------------------------------------
# the port on 4 gloo ranks
# ---------------------------------------------------------------------------

def _spy(opt, seen: dict):
    """``opt`` whose ``apply`` keeps the first gradient it is handed."""
    real_apply = opt.apply

    def apply(grads, state, p, step, **kw):
        if step == 0:
            seen["grads"] = tree_map(torch.clone, grads)
        return real_apply(grads, state, p, step, **kw)

    return dataclasses.replace(opt, apply=apply)


def _in_thread(fn, *args, **kw):
    """``fn(*args, **kw)`` on a new thread, which sees none of this
    thread's thread-locals."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn(*args, **kw)))
    t.start()
    t.join()
    return out[0]


def _case(name, full: dict, batch: dict, out_dir: str, res: dict,
          meta: dict) -> None:
    key, (dp, tp), zero, head, masked = CASES[name]
    model = Model(_cfg(get_config, KV[key]), "cpu", xent_impl=head)
    strat = StrategySpec(dp=dp, tp=tp, zero=zero)
    plan = planner.compile_plan(
        model, planner.mesh_for_strategy(strat, device_type="cpu"), strat)
    params = plan.shard(tree_map(torch.clone, full[key]), plan.param_specs)
    seen = {}
    opt = _spy(adamw(lr=LR), seen)
    state = {"params": params, "opt": plan.init_opt(opt, params)}
    ckpt = None
    if name in CKPT:
        ckpt = CheckpointManager(
            os.path.join(out_dir, f"ck_{name}"), keep=3,
            rank=dist.get_rank(), barrier=dist.barrier,
            gather=lambda tree: plan.gather_state(tree, opt))
        ckpt.save(0, state)
    step = plan.train_step_fn(opt)
    mine = plan.batch_slice(batch if masked else
                            {"tokens": batch["tokens"]})
    losses = []
    real_grad = torch.autograd.grad
    if name.endswith("backward_thread"):
        torch.autograd.grad = functools.partial(_in_thread, real_grad)
    try:
        for i in range(STEPS):
            p, o, m = step(state["params"], state["opt"], mine, i)
            state = {"params": p, "opt": o}
            losses.append(float(m["loss"]))
    finally:
        torch.autograd.grad = real_grad
    grads = tree_map(lambda g, s: sharding.gather_leaf(g, s, plan.rules),
                     seen["grads"], plan.param_specs)
    whole = plan.gather_state(state, opt)
    info = {"losses": losses, "layout": None,
            "split": [list(map(int, v.shape))
                      for v in flatten(state["params"])[1]]}
    with sharding.use_rules(plan.rules):
        info["layout"] = attention.choose_layout(model.cfg.attn_cfg())
    if ckpt is not None:
        ckpt.save(STEPS, state)
        _, back, _ = plan.restore_state(ckpt, opt)
        info["restored"] = all(
            torch.equal(a, b) for a, b in zip(flatten(back)[1],
                                              flatten(state)[1]))
    meta[name] = info
    if dist.get_rank() == 0:
        for path, v in zip(*flatten(grads)):
            res[f"{name}/grads/{path}"] = v.detach().numpy()
        for path, v in zip(*flatten(whole)):
            res[f"{name}/state/{path}"] = v.detach().numpy()


def _zero3_compress(meta: dict) -> None:
    """ZeRO-3 beside compress_pod wants a plan compiled for it (its
    parameters sharded inside each pod), on a pod 2 × data 2 mesh."""
    cfg = _cfg(get_config, KV["A"])
    strat = StrategySpec(dp=4, zero=3)
    plan = planner.compile_plan(Model(cfg, "cpu"), planner.mesh_for_strategy(
        strat, pods=2, device_type="cpu"), strat)
    try:
        plan.train_step_fn(adamw(lr=LR), compress_pod=True)
    except ValueError as e:
        meta["zero3_compress"] = str(e)


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    d = dict(np.load(inputs))
    full = {key: params_from_numpy(
        _cfg(get_config, kv), {k[len(f"{key}/"):]: v for k, v in d.items()
                               if k.startswith(f"{key}/")}, "cpu")
        for key, kv in KV.items()}
    batch = {"tokens": torch.tensor(d["tokens"]),
             "loss_mask": torch.tensor(d["mask"])}
    res, meta = {}, {}
    for name in CASES:
        _case(name, full, batch, out_dir, res, meta)
    _zero3_compress(meta)
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("tp4")
    np.savez(d / "inputs.npz", tokens=ref["tokens"], mask=ref["mask"],
             **{f"{key}/{k}": v for key in KV
                for k, v in ref[key, "params"].items()})
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
    return dict(np.load(d / "rank0.npz")), metas, d


def _tree(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_reference(name, ranks, ref):
    """The step-0 loss and every gathered step-0 gradient leaf against the
    reference's unmeshed ``loss_fn``; three AdamW steps' losses against
    its optimizer loop; every rank reports the same losses."""
    res, metas, _ = ranks
    key, (dp, tp), zero, head, masked = CASES[name]
    want_loss, want_g = ref[key, masked]
    got = metas[0][name]["losses"]
    np.testing.assert_allclose(got[0], want_loss, atol=TOL.fwd, rtol=TOL.fwd)
    grads = _tree(res, f"{name}/grads/")
    assert sorted(grads) == sorted(want_g)
    for path, w in want_g.items():
        np.testing.assert_allclose(grads[path], w, atol=TOL.grad,
                                   rtol=TOL.grad, err_msg=f"{name} {path}")
    np.testing.assert_allclose(got, ref[key, masked, "losses"],
                               atol=TOL.fwd, rtol=TOL.fwd)
    assert all(m[name]["losses"] == got for m in metas)
    want_layout = "grouped" if KV[key] % tp == 0 else "repeat"
    assert metas[0][name]["layout"] == want_layout


def test_each_rank_holds_its_blocks(ranks):
    """At tp 4 the vocab rows, heads and MLP columns are a quarter each
    (wk/wv whole under repeat); ZeRO-3 also halves a dim over data."""
    _, metas, _ = ranks
    full = [list(v.shape) for v in flatten(
        Model(_cfg(get_config, KV["A"]), "meta").init(0))[1]]
    paths = flatten(Model(_cfg(get_config, KV["A"]), "meta").init(0))[0]
    tp4 = dict(zip(paths, metas[0]["tp4"]["split"]))
    assert tp4["embed/table"] == [128, 128]
    assert tp4["head/w"] == [128, 128]
    assert tp4["blocks/p0/attn/wq"] == [2, 128, 1, 32]
    assert tp4["blocks/p0/attn/wk"] == [2, 128, 2, 32]
    assert tp4["blocks/p0/mlp/wi"] == [2, 128, 64]
    z3 = dict(zip(paths, metas[0]["zero3"]["split"]))
    tp2 = dict(zip(paths, metas[0]["tp2"]["split"]))
    assert z3["embed/table"] == [256, 64] and tp2["embed/table"] == [256,
                                                                    128]
    assert z3["blocks/p0/norm1/scale"] == [2, 128]       # < 65536 elements
    assert sum(np.prod(s) for s in full) > 2 * sum(
        np.prod(s) for s in z3.values())


def test_zero1_equals_zero0_bit_for_bit_and_zero3_is_close(ranks):
    """ZeRO-1 equals ZeRO-0 bit for bit; ZeRO-3 too without a mask, and
    within f32's tolerance with one."""
    res, metas, _ = ranks
    assert metas[0]["zero1"]["losses"] == metas[0]["tp2"]["losses"]
    z0, z1 = _tree(res, "tp2/state/"), _tree(res, "zero1/state/")
    assert sorted(z0) == sorted(z1)
    for path in z0:
        np.testing.assert_array_equal(z1[path], z0[path], err_msg=path)
    # masked, ZeRO-3 weights the loss before its reduce-scatter (ZeRO-0
    # weights the gradient after its all-reduce): within f32's tolerance
    np.testing.assert_allclose(metas[0]["zero3"]["losses"],
                               metas[0]["tp2"]["losses"], atol=TOL.fwd,
                               rtol=TOL.fwd)
    got, want = _tree(res, "zero3/grads/"), _tree(res, "tp2/grads/")
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=TOL.fwd,
                                   rtol=TOL.fwd, err_msg=path)
    # unmasked, the same sums in the same order and a clip norm summed in
    # f64: bit for bit, moments included
    assert metas[0]["zero3_fused"]["losses"] == \
        metas[0]["tp2_fused"]["losses"]
    z0, z3 = _tree(res, "tp2_fused/state/"), _tree(res, "zero3_fused/state/")
    for path in z0:
        np.testing.assert_array_equal(z3[path], z0[path], err_msg=path)


def test_sharded_checkpoints_match_unsharded_files(ranks, ref, tmp_path):
    """The sharded start writes the unsharded start's files byte for byte
    (the reference's layout, from rank 0); ZeRO-1's last step writes
    ZeRO-0's; every sharded checkpoint restores into the rank's shards."""
    _, metas, d = ranks
    cfg = _cfg(get_config, KV["A"])
    full = params_from_numpy(cfg, ref["A", "params"], "cpu")
    CheckpointManager(str(tmp_path)).save(
        0, {"params": full, "opt": adamw(lr=LR).init(full)})

    def files(path):
        return {f: open(os.path.join(path, f), "rb").read()
                for f in sorted(os.listdir(path))}

    want = files(tmp_path / "step_00000000")
    assert len(want) == 1 + len(flatten(full)[1]) * 3
    for name in CKPT:
        assert files(d / f"ck_{name}" / "step_00000000") == want, name
        assert all(m[name]["restored"] for m in metas), name
    assert files(d / "ck_zero1" / f"step_{STEPS:08d}") == \
        files(d / "ck_tp2" / f"step_{STEPS:08d}")


def test_remaining_refusals_name_their_item(ranks):
    """The seq layout and ZeRO with uneven batch shares still raise, each
    naming ROADMAP.md queue A item 4 (ZeRO with compress_pod trains:
    tests/test_torch_grad_compress.py; ZeRO-3 with it wants a plan
    compiled with ``compress_pod``).  A pipeline with a model axis and
    ZeRO compiles, and its ZeRO lays nothing over data (the reference's
    staged specs: the pipeline's caveat)."""
    _, metas, _ = ranks
    assert "compress_pod=True" in metas[0]["zero3_compress"]
    strat = StrategySpec(dp=2, tp=2, pp=2, zero=3)
    plan = planner.ExecutionPlan(
        model=Model(_cfg(get_config, KV["A"]), "meta"), mesh=None,
        strategy=strat, rules=sharding.rules_for_strategy(
            {"stage": 2, "data": 2, "model": 2}, strat))
    assert plan.state_layout(adamw())["mu"] == plan.param_specs
    assert not any(a == "data" for spec in flatten(plan.param_specs)[1]
                   for e in spec for a in sharding._axes(e))
    from repro_torch.core import cost_model as cm
    spec = cm.ClusterSpec(groups=(
        cm.DeviceGroup("v100", cm.V100_PAPER, 4),
        cm.DeviceGroup("p100", cm.P100_16G, 4)))
    cfg = _cfg(get_config, KV["A"])
    meta = Model(cfg, "meta").graph(8, 64).workload_meta()
    assert planner.compile_plan(None, None, StrategySpec(dp=8),
                                cluster_spec=spec, workload_meta=meta,
                                overlap=0.5).replica_rows() == (
        2, 2, 2, 1, 1, 0, 0, 0)
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        planner.compile_plan(None, None, StrategySpec(dp=8, zero=1),
                             cluster_spec=spec, workload_meta=meta,
                             overlap=0.5)

    class _Mesh:
        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    odd = dataclasses.replace(cfg.attn_cfg(), n_heads=6, n_kv_heads=2)
    rules = sharding.hybrid_rules({"data": 1, "model": 4}, mesh=_Mesh())
    x = torch.zeros(1, 4, cfg.d_model)
    with sharding.use_rules(rules), pytest.raises(NotImplementedError,
                                                  match="queue A item 4"):
        attention.attention({}, x, torch.zeros(1, 4), odd)


@pytest.mark.parametrize("H,K,tp", [(4, 1, 2), (4, 2, 4), (12, 4, 6),
                                    (12, 4, 3), (32, 4, 8)])
def test_repeat_keeps_the_kv_heads_of_each_rank_q_heads(H, K, tp):
    """Each rank's kv heads, as the flash kernel groups them over its q
    heads, are the reference's KV repeated to the q heads and split with
    them (``repro/models/attention.py``'s ``repeat`` layout), whether a
    group lies in one rank or straddles two."""
    cfg = attention.AttnCfg(d_model=8, n_heads=H, n_kv_heads=K, head_dim=1)
    w = torch.arange(8 * K, dtype=torch.float32).reshape(8, K, 1)
    repeated = np.repeat(w.numpy(), H // K, axis=1)      # (E, H, 1)
    hl = H // tp
    for r in range(tp):
        mine = attention._own_kv(w, sharding.Split(None, tp, r), cfg)
        per_q = hl // mine.shape[1]                      # flash's group
        got = mine.numpy()[:, [j // per_q for j in range(hl)]]
        np.testing.assert_array_equal(got, repeated[:, r * hl:(r + 1) * hl])


# ---------------------------------------------------------------------------
# the driver under torchrun
# ---------------------------------------------------------------------------

def _torchrun(argv, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", "--seq", "32", "--log-every", "1"]
        + argv, capture_output=True, text=True, timeout=300, env=env,
        cwd=str(cwd))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    return p.stdout


def _losses(stdout: str) -> list:
    return [float(line.split()[3]) for line in stdout.splitlines()
            if line.strip().startswith("step ")]


def test_train_driver_mesh_2x2_trains_and_resumes(tmp_path):
    """``--mesh 2x2`` trains data 2 × model 2 (the [plan] line names the
    split), writes the reference's checkpoint from rank 0 and resumes
    into its shards, continuing the uninterrupted run's losses."""
    ck = str(tmp_path / "ck")
    base = ["--mesh", "2x2", "--batch", "4", "--ckpt-dir", ck]
    first = _torchrun(base + ["--steps", "2", "--save-every", "2"], tmp_path)
    assert "[plan] mesh {'data': 2, 'model': 2}; split×2 over model " \
           "(heads, MLP columns, vocab)" in first
    assert "replica×2{split×2}" in first
    rest = _torchrun(base + ["--steps", "3"], tmp_path)
    assert "[resume] from step 2" in rest
    straight = _torchrun(["--mesh", "2x2", "--batch", "4", "--steps", "3",
                          "--ckpt-dir", str(tmp_path / "ck2")], tmp_path)
    got, want = _losses(first) + _losses(rest), _losses(straight)
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    with open(tmp_path / "ck" / "step_00000003" / "MANIFEST.json") as f:
        manifest = json.load(f)
    shapes = dict(zip(manifest["paths"], manifest["shapes"]))
    assert shapes["params/embed/table"] == [512, 128]    # gathered whole


def test_train_driver_auto_trains_the_split_it_picks(tmp_path):
    """The search over 4 devices picks ``replica×2{split×2}`` for the
    3-layer smoke model at batch 2 x 32 on the H100 table, and the driver
    trains it."""
    out = _torchrun(["--auto", "--overrides", "n_layers=3", "--batch", "2",
                     "--steps", "2", "--ckpt-dir", str(tmp_path / "ck")],
                    tmp_path)
    assert "[auto] chose: replica×2{split×2}\n" in out
    losses = _losses(out)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (tmp_path / "ck" / "step_00000002.COMMITTED").exists()
