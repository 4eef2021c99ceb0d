"""The port's data-parallel slice with cross-pod int8 gradient compression
(``repro_torch``) against the reference (``repro``) on the CPU: the quant
kernels' plain versions, ``grad_compress``, the mesh, the planner's
data-parallel step and the training driver's ``--mesh … --compress-pod``.

Inputs are made with numpy from a seed (or by the reference, then carried
over as numpy).  The reference's Pallas quant kernel runs in interpret
mode, as tests/test_kernels.py runs it.  Multi-rank checks run the port on
4 gloo ranks (``torch.multiprocessing.spawn`` over a ``FileStore`` in
``tmp_path``, so parallel test workers share no port) and the reference
under ``shard_map`` on a 4-device CPU mesh in a subprocess
(``XLA_FLAGS`` must be set before its first ``import jax``).  The
reference's own meshed compressed step does not run on this jax (see
tests/test_distributed.py::test_compress_pod_training_step), so the step
is held against one composed from the reference's unmeshed parts:
``value_and_grad(Model.loss_fn)`` per rank's rows, the in-pod mean,
``compressed_psum`` under ``shard_map`` over ``pod``, and ``adamw``.

Tolerances.  The quant kernels' plain versions equal the reference kernel
in interpret mode bit for bit: int8 values, scales, NaNs.  The reference's
jnp ``grad_compress`` is held to its own kernel's numbers only up to two
roundings that XLA chooses per program when it compiles it: ``/ 127``
becomes a product with 1/127 in some programs (as in the kernel, and in the
port) and stays a division in others (1 ulp apart), and ``x − q·s`` is
fused into one multiply-add (one rounding fewer).  So against it
(:func:`assert_within_quanta`) every element agrees within a few ulps,
except where ``x/s`` lay within an ulp of a rounding boundary and the int8
value flipped: there the difference is at most one quantum (the output's
``smax/n``, the residual's ``s + smax``), and such elements are rare.
Losses are held at the f32 value tolerance 2e-5 and gradients at 2e-4
(tests/torch_harness.py).
A whole step is held in three parts: the gradient it hands to the
optimizer equals the port's compression of its own in-pod gradients bit
for bit, and the reference's within quanta; the parameters it returns are
the reference's AdamW of that gradient within ``1e-3·lr``; and against the
reference's step they agree within ``0.02·lr`` wherever the two handed
gradients agree to 1%.  AdamW's first update is ``lr·g/(|g|+ε)``, about
``lr·sign(g)``, so where they do not (a flipped int8 value on a small
element) a parameter may move by up to ``2·lr``; at most 1% may.

Blocks of leaves (one more spawn of 4 gloo ranks): at pod 2 × model 2
each rank compresses its model shard of every leaf; the pods' in-pod
gradients, gathered whole, go through the reference's
``compressed_psum_tree`` under ``jax.vmap`` over ``pod`` (its scale is
the whole leaf's abs-max), and the step's handed gradient and error carry
agree within the quanta above (a scale per shard, the old code, fails
this).  At pod 2 × data 2, compressed ZeRO-1 and ZeRO-3 equal compressed
ZeRO-0 bit for bit over three steps, error carry included, and each
level's checkpoint restores into every level's blocks bit for bit; the
driver's ``--zero`` beside ``--compress-pod`` under ``torchrun`` trains
and resumes across levels.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.kernels.quant.quant import dequantize as jax_dequantize
from repro.kernels.quant.quant import quantize as jax_quantize
from repro.kernels.quant.ref import dequant_ref as jax_dequant_ref
from repro.kernels.quant.ref import quant_ref as jax_quant_ref
from repro.optim import grad_compress as jax_gc
from repro.optim import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.core.cost_model import StrategySpec
from repro_torch.kernels.quant.quant import (SMALL_BLOCK, dequantize,
                                             quantize, slices)
from repro_torch.kernels.quant.ref import dequant_ref, quant_ref
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim import grad_compress as gc
from repro_torch.optim.optimizer import adamw
from repro_torch.tree import flatten, unflatten

from torch_harness import TOLS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
LR = 1e-3                      # the DP step's constant learning rate
ROUNDS = 3                     # error-feedback rounds of compressed_psum
PSUM_N = 1000                  # elements per rank in the compressed_psum test
STEP_BATCH, STEP_SEQ = 8, 32   # the DP step's global batch (2 rows a rank)
MESH_SPECS = ("4", "2x2", "2x2x1")


# ---------------------------------------------------------------------------
# the quant kernels' plain versions
# ---------------------------------------------------------------------------

def assert_within_quanta(got, want, quantum, ulps_of, *, max_flips=0.01,
                         slack=0.0, what=""):
    """Elementwise: ``|got − want| ≤ 4·ulp(ulps_of) + slack`` (roundings,
    and a difference the caller derives from its inputs'), or at most one
    ``quantum`` more where an int8 value flipped; flips on at most
    ``max_flips`` of the elements."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tight = 4 * np.spacing(np.abs(np.float32(ulps_of))) + \
        4 * np.spacing(np.abs(want)) + slack
    d = np.abs(got - want)
    flips = d > tight
    assert (d[flips] <= (quantum + tight[flips]) * (1 + 1e-6)).all(), \
        f"{what}: max |diff| {d.max():.3e}, one quantum {quantum:.3e}"
    assert flips.mean() <= max_flips, f"{what}: {flips.sum()} flips"
    return int(flips.sum())


def _quant_input(T, dtype, nan, seed=0):
    x = (np.random.default_rng(seed).standard_normal(T) * 5).astype(
        np.float32)
    if nan:
        x[T // 3] = np.nan
    jx = jnp.asarray(x, dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    return jx, tx


@pytest.mark.parametrize("block", ["256", "T"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nan", [False, True])
def test_plain_quant_matches_reference_kernel_and_oracle(block, dtype, nan):
    T = 2048
    blk = T if block == "T" else int(block)
    jx, tx = _quant_input(T, dtype, nan)
    q, s = quantize(tx, block=blk)
    jq, js = jax_quantize(jx, block=blk, interpret=True)
    # the oracle compiled, as the kernel is (``/ 127`` as XLA lowers it)
    rq, rs = jax.jit(jax_quant_ref, static_argnums=1)(jx, blk)
    jx_deq = jax_dequantize(jq, js, block=blk, interpret=True)
    for want_q, want_s in ((jq, js), (rq, rs)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    if nan:                      # the NaN's block: scale NaN, every q 0
        b = (T // 3) // blk
        assert np.isnan(s[b].item()) and not q[b * blk:(b + 1) * blk].any()
    else:                        # the port's copy of the oracle, too
        oq, os_ = quant_ref(tx, block=blk)
        np.testing.assert_array_equal(oq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(os_.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(
            dequant_ref(oq, os_, block=blk).numpy(),
            np.asarray(jax_dequant_ref(rq, rs, block=blk)))
        # run op by op the oracle divides: its scales are within 1 ulp
        es = np.asarray(jax_quant_ref(jx, block=blk)[1])
        np.testing.assert_allclose(s.numpy(), es, rtol=2 ** -23, atol=0)
    x = dequantize(q, s, block=blk)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx_deq))
    assert x.dtype == torch.float32


def test_quant_wrappers_raise_and_count_nothing_on_cpu():
    n0 = (quantize.launches, dequantize.launches)
    x = torch.randn(1000)
    with pytest.raises(ValueError, match="must divide"):
        quantize(x, block=256)
    with pytest.raises(ValueError, match="must divide"):
        dequantize(torch.zeros(1000, dtype=torch.int8), torch.ones(3),
                   block=256)
    q, s = quantize(x, block=250)
    dequantize(q, s, block=250)
    assert (quantize.launches, dequantize.launches) == n0
    with pytest.raises(ValueError, match="cpu or cuda"):
        quantize(torch.empty(512, device="meta"), block=256)


@pytest.mark.parametrize("T,block,sms,want", [
    (1 << 26, 256, 132, 1),                       # one warp per block
    (22 * 2048 * 5632, 22 * 2048 * 5632, 132, 1056),   # tinyllama's wi
    (2048 * 5632, 2048 * 5632, 132, 1056),
    (64000, 64000, 132, 16),                      # at most block / 4096
    (1 << 20, 1 << 16, 132, 16),                  # 16 blocks x 66 wanted
])
def test_kernel_slices_cover_each_block(T, block, sms, want):
    parts = slices(T, block, sms)
    assert parts == want
    assert parts == 1 or -(-block // parts) >= SMALL_BLOCK // 2


# ---------------------------------------------------------------------------
# quantize_int8 / dequantize_int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_err", [False, True])
def test_quantize_int8_matches_reference(with_err):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 7)) * 0.02).astype(np.float32)
    err = ((rng.standard_normal(x.shape) * 1e-4).astype(np.float32)
           if with_err else None)
    q, scale, new_err = gc.quantize_int8(
        torch.tensor(x), None if err is None else torch.tensor(err))
    jq, js, je = jax.jit(jax_gc.quantize_int8)(
        jnp.asarray(x), None if err is None else jnp.asarray(err))
    assert q.shape == x.shape and q.dtype == torch.int8 and scale.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    # the port rounds q·s, then subtracts; XLA fuses the two (one rounding)
    xf = x if err is None else x + err
    np.testing.assert_array_equal(
        new_err.numpy(), xf - q.numpy().astype(np.float32) * scale.numpy())
    np.testing.assert_allclose(new_err.numpy(), np.asarray(je), rtol=0,
                               atol=np.spacing(np.float32(127 * js)))
    np.testing.assert_array_equal(
        gc.dequantize_int8(q, scale).numpy(),
        np.asarray(jax_gc.dequantize_int8(jq, js)))


# ---------------------------------------------------------------------------
# the reference side of the multi-rank checks (one subprocess, 4 devices)
# ---------------------------------------------------------------------------

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config
from repro.core.cost_model import StrategySpec
from repro.core.jax_compat import shard_map
from repro.core.planner import mesh_for_strategy
from repro.data import pipeline
from repro.launch.train import parse_mesh
from repro.models.lm import build
from repro.optim import grad_compress as gc
from repro.optim import optimizer as jopt

out_path, ROUNDS, N, LR, B, S, steps = sys.argv[1:8]
ROUNDS, N, B, S, steps = map(int, (ROUNDS, N, B, S, steps))
LR = float(LR)
res = {}
meta = {"mesh": {}}
for spec in ("4", "2x2", "2x2x1"):
    meta["mesh"][spec] = dict(parse_mesh(spec).shape)
for name, strat, pods in (("dp4_pods2", StrategySpec(dp=4), 2),
                          ("dp2_tp2", StrategySpec(dp=2, tp=2), 1),
                          ("dp2_pp2", StrategySpec(dp=2, pp=2,
                                                   schedule="1f1b"), 1)):
    meta["mesh"][name] = dict(mesh_for_strategy(strat, pods=pods).shape)
    meta[name] = strat.describe()

# compressed_psum, fully manual shard_map, 3 error-feedback rounds
rng = np.random.default_rng(7)
for layout, shape, names, spec in (("pod4", (4,), ("pod",), P("pod")),
                                   ("pod2x2", (2, 2), ("pod", "data"),
                                    P(("pod", "data")))):
    mesh = jax.make_mesh(shape, names)
    err = None
    for r in range(ROUNDS):
        x = (rng.standard_normal((4, N)) * 10 ** rng.uniform(-3, 1, (4, 1))
             ).astype(np.float32)
        res[f"cp/{layout}/{r}/x"] = x
        if err is None:
            f = jax.jit(shard_map(lambda a: tuple(o[None] for o in
                                  gc.compressed_psum(a[0], "pod")),
                                  mesh=mesh, in_specs=(spec,),
                                  out_specs=(spec, spec)))
            out, err = f(jnp.asarray(x))
        else:
            f = jax.jit(shard_map(lambda a, e: tuple(o[None] for o in
                                  gc.compressed_psum(a[0], "pod", e[0])),
                                  mesh=mesh, in_specs=(spec, spec),
                                  out_specs=(spec, spec)))
            out, err = f(jnp.asarray(x), err)
        res[f"cp/{layout}/{r}/out"] = np.asarray(out)
        res[f"cp/{layout}/{r}/err"] = np.asarray(err)

# one DP step over pod 2 x data 2, composed from unmeshed parts
cfg = get_config("tinyllama-1.1b", smoke=True)
model = build(cfg)
params = model.init(jax.random.key(0))
paths = _leaf_paths(params)
for p, v in zip(paths, jax.tree.leaves(params)):
    res[f"init/{p}"] = np.asarray(v)
tokens = np.random.default_rng(3).integers(0, cfg.vocab, (B, S)).astype(
    np.int32)
res["tokens"] = tokens
grad_fn = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))
rows = B // 4
outs = [grad_fn(params, {"tokens": jnp.asarray(tokens[r * rows:(r + 1) * rows])})
        for r in range(4)]
res["loss"] = np.float32(sum(float(l) for (l, _), _ in outs) / 4)
# a random loss_mask: one masked mean over the whole batch
mask = (np.random.default_rng(4).random((B, S)) < 0.7).astype(np.float32)
res["mask"] = mask
res["masked_loss"] = np.float32(grad_fn(params, {
    "tokens": jnp.asarray(tokens), "loss_mask": jnp.asarray(mask)})[0][0])
g = [o[1] for o in outs]
inpod = [jax.tree.map(lambda a, b: (a + b) / 2, g[2 * p], g[2 * p + 1])
         for p in range(2)]
for p in range(2):
    for path, v in zip(paths, jax.tree.leaves(inpod[p])):
        res[f"inpod/{p}/{path}"] = np.asarray(v)
stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), *inpod)
err0 = jax.tree.map(lambda a: jnp.zeros((2,) + a.shape[1:], jnp.float32),
                    stacked)
pod_mesh = jax.make_mesh((2,), ("pod",), devices=jax.devices()[:2])
def body(gs, es):
    gs = jax.tree.map(lambda a: a[0], gs)
    es = jax.tree.map(lambda a: a[0], es)
    o, e = gc.compressed_psum_tree(gs, "pod", es, mean=True)
    return (jax.tree.map(lambda a: a[None], o),
            jax.tree.map(lambda a: a[None], e))
cg, ce = jax.jit(shard_map(body, mesh=pod_mesh, in_specs=(P("pod"), P("pod")),
                   out_specs=(P("pod"), P("pod"))))(stacked, err0)
for path, a, e in zip(paths, jax.tree.leaves(cg), jax.tree.leaves(ce)):
    res[f"comp/out/{path}"] = np.asarray(a)
    res[f"comp/err/{path}"] = np.asarray(e)
plain = jax.tree.map(lambda a, b: (a + b) / 2, *inpod)
# (out_specs P("pod") gives pod-sharded arrays: index them on the host)
for name, grads in (("comp", jax.tree.map(
                        lambda a: jnp.asarray(np.asarray(a)[0]), cg)),
                    ("plain", plain)):
    o = jopt.adamw(lr=LR)
    new, _ = o.apply(grads, o.init(params), params, 0)
    for path, v in zip(paths, jax.tree.leaves(new)):
        res[f"{name}/params/{path}"] = np.asarray(v)
    for path, v in zip(paths, jax.tree.leaves(grads)):
        res[f"{name}/grads/{path}"] = np.asarray(v)

# the driver's --mesh 1x1x1 --compress-pod loop: a pod of one
sched = jopt.Schedule(base_lr=3e-4, warmup=min(100, steps // 10 + 1),
                      decay_steps=steps)
o = jopt.adamw(lr=sched)
state = o.init(params)
for path, v in zip(_leaf_paths(state), jax.tree.leaves(state)):
    res[f"drv/opt/{path}"] = np.asarray(v)
data = pipeline.TokenPipeline(pipeline.DataCfg(global_batch=2, seq_len=32,
                                               vocab=cfg.vocab, seed=0),
                              host_id=0, n_hosts=1)
meta["data"] = data.state_dict()
one = jax.make_mesh((1,), ("pod",), devices=jax.devices()[:1])
comp = jax.jit(shard_map(
    lambda g, e: gc.compressed_psum_tree(g, "pod", e, mean=True),
    mesh=one, in_specs=(P(), P()), out_specs=(P(), P())))
err = gc.init_error_tree(params)
p = params
losses = []
for i in range(steps):
    (loss, _), grads = grad_fn(p, {"tokens": jnp.asarray(
        data.next_batch()["tokens"])})
    grads, err = comp(grads, err)
    p, state = o.apply(grads, state, p, i)
    losses.append(float(loss))
meta["drv_losses"] = losses
np.savez(out_path + ".npz", **res)
with open(out_path + ".json", "w") as f:
    json.dump(meta, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref") / "ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), out, str(ROUNDS),
         str(PSUM_N), str(LR), str(STEP_BATCH), str(STEP_SEQ), "3"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    with open(out + ".json") as f:
        meta = json.load(f)
    return dict(np.load(out + ".npz")), meta, out + ".npz"


# ---------------------------------------------------------------------------
# the port on 4 gloo ranks (one spawn for every multi-rank check)
# ---------------------------------------------------------------------------

def _tree(ref: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _rank_main(rank: int, world: int, store: str, ref_path: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    ref = dict(np.load(ref_path))
    res, meta = {}, {"mesh": {}}
    # meshes, and the refusals that need one
    for spec in MESH_SPECS:
        m = port_mesh.parse_mesh(spec, device_type="cpu")
        meta["mesh"][spec] = port_mesh.mesh_shape(m)
    for name, strat, pods in (("dp4_pods2", StrategySpec(dp=4), 2),
                              ("dp2_tp2", StrategySpec(dp=2, tp=2), 1),
                              ("dp2_pp2", StrategySpec(
                                  dp=2, pp=2, schedule="1f1b"), 1)):
        m = planner.mesh_for_strategy(strat, pods=pods, device_type="cpu")
        meta["mesh"][name] = port_mesh.mesh_shape(m)
        meta[name] = strat.describe()
    cfg = get_config(ARCH, smoke=True)
    model = Model(cfg, "cpu")
    # a model axis compiles: data 2 x model 2 is split×2 in each replica
    tp_plan = planner.compile_plan(model, port_mesh.parse_mesh(
        "2x2", device_type="cpu"))
    meta["tp_plan"] = [tp_plan.strategy.describe(), tp_plan.sharded]
    # compressed_psum, 3 error-feedback rounds, two layouts
    for layout, shape, names in (("pod4", (4,), ("pod",)),
                                 ("pod2x2", (2, 2), ("pod", "data"))):
        group = port_mesh.make_mesh(shape, names, device_type="cpu"
                                    ).get_group("pod")
        err = None
        for r in range(ROUNDS):
            x = torch.tensor(ref[f"cp/{layout}/{r}/x"][rank])
            out, err = gc.compressed_psum(x, group, err)
            res[f"cp/{layout}/{r}/out"] = out.numpy()
            res[f"cp/{layout}/{r}/err"] = err.numpy()
    # the planner's DP step on pod 2 x data 2, with and without compression
    mesh = port_mesh.parse_mesh("2x2x1", device_type="cpu")
    plan = planner.compile_plan(model, mesh)
    meta["strategy"] = plan.strategy.describe()
    batch = plan.batch_slice({"tokens": ref["tokens"]})
    meta["rows"] = batch["tokens"].tolist()
    batch = {"tokens": torch.tensor(batch["tokens"])}
    seen = {}
    real_tree = gc.compressed_psum_tree

    def spy_tree(grads, group, err_tree, **kw):
        seen["inpod"] = {k: v.clone() for k, v in zip(*flatten(grads))}
        return real_tree(grads, group, err_tree, **kw)

    gc.compressed_psum_tree = spy_tree
    try:
        for name, compress in (("comp", True), ("plain", False)):
            params = params_from_numpy(cfg, _tree(ref, "init/"), "cpu")
            opt = adamw(lr=LR)
            real_apply = opt.apply

            def apply(grads, state, p, step, real_apply=real_apply):
                seen["grads"] = {k: v.clone() for k, v in zip(*flatten(grads))}
                return real_apply(grads, state, p, step)

            opt = dataclasses.replace(opt, apply=apply)
            step = plan.train_step_fn(opt, compress_pod=compress)
            args = (params, opt.init(params), batch, 0)
            if compress:
                args += (gc.init_error_tree(params),)
            out = step(*args)
            res[f"{name}/loss"] = out[2]["loss"].numpy()
            for path, v in zip(*flatten(out[0])):
                res[f"{name}/params/{path}"] = v.detach().numpy()
            for path, v in seen["grads"].items():
                res[f"{name}/grads/{path}"] = v.numpy()
            if compress:
                inpod = seen.pop("inpod")
                for path, v in inpod.items():
                    res[f"inpod/{path}"] = v.numpy()
                for path, v in zip(*flatten(out[3])):
                    res[f"comp/err/{path}"] = v.numpy()
    finally:
        gc.compressed_psum_tree = real_tree
    # the step's own in-pod gradients through the compressor once more (it
    # may reuse its inputs' storage, which res still views)
    g = unflatten(list(inpod), [v.clone() for v in inpod.values()])
    g, err = gc.compressed_psum_tree(g, mesh.get_group("pod"),
                                     gc.init_error_tree(g))
    for path, v in zip(*flatten(g)):
        res[f"again/out/{path}"] = v.numpy()
    for path, v in zip(*flatten(err)):
        res[f"again/err/{path}"] = v.numpy()
    # the compressor fed the reference's in-pod gradients: exact
    pod = mesh.get_local_rank("pod")
    grads = {k: torch.tensor(v) for k, v in
             _tree(ref, f"inpod/{pod}/").items()}
    g = unflatten(list(grads), list(grads.values()))
    err = gc.init_error_tree(g)
    g, err = gc.compressed_psum_tree(g, mesh.get_group("pod"), err)
    for path, v in zip(*flatten(g)):
        res[f"exact/out/{path}"] = v.numpy()
    for path, v in zip(*flatten(err)):
        res[f"exact/err/{path}"] = v.numpy()
    # a batch pod x data does not divide is refused; a loss_mask takes the
    # token-weighted mean over pod x data
    try:
        plan.batch_slice({"tokens": np.zeros((6, 4), np.int32)})
    except ValueError as e:
        meta["batch_refused"] = str(e)
    masked = {k: torch.tensor(v) for k, v in plan.batch_slice(
        {"tokens": ref["tokens"], "loss_mask": ref["mask"]}).items()}
    params = params_from_numpy(cfg, _tree(ref, "init/"), "cpu")
    opt = adamw(lr=LR)
    meta["masked_loss"] = float(plan.train_step_fn(opt)(
        params, opt.init(params), masked, 0)[2]["loss"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port4(reference, tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("port4")
    mp.spawn(_rank_main, args=(4, str(d / "store"), reference[2], str(d)),
             nprocs=4, join=True)
    out = []
    for r in range(4):
        with open(d / f"rank{r}.json") as f:
            out.append((dict(np.load(d / f"rank{r}.npz")), json.load(f)))
    return out


@pytest.mark.parametrize("layout", ["pod4", "pod2x2"])
def test_compressed_psum_matches_reference_over_three_rounds(layout,
                                                             reference,
                                                             port4):
    ref = reference[0]
    n = 4 if layout == "pod4" else 2                # ranks in a pod group
    for rank, (got, _) in enumerate(port4):
        group = [0, 1, 2, 3] if n == 4 else [rank % 2, rank % 2 + 2]
        prev = 0.0
        for r in range(ROUNDS):
            # the group's largest scale, from its inputs plus carried errors
            xs = ref[f"cp/{layout}/{r}/x"][group]
            if r:
                xs = xs + ref[f"cp/{layout}/{r - 1}/err"][group]
            smax = np.abs(xs).max() / 127
            tag = f"{layout} round {r} rank {rank}"
            # the carried residuals differ by roundings of the size of the
            # last round's quanta, and so do this round's scales
            assert_within_quanta(got[f"cp/{layout}/{r}/out"],
                                 ref[f"cp/{layout}/{r}/out"][rank],
                                 smax / n, 127 * prev, what=tag + " out")
            assert_within_quanta(got[f"cp/{layout}/{r}/err"],
                                 ref[f"cp/{layout}/{r}/err"][rank],
                                 2 * smax, 127 * max(smax, prev),
                                 what=tag + " err")
            prev = smax


def test_mesh_shapes_and_names_match_reference(reference, port4):
    want = reference[1]
    for _, meta in port4:
        assert meta["mesh"] == want["mesh"]
        assert meta["dp4_pods2"] == want["dp4_pods2"] == "replica×4"
        assert meta["dp2_tp2"] == want["dp2_tp2"]
        assert meta["dp2_pp2"] == want["dp2_pp2"]
        assert meta["strategy"] == "replica×4"
    assert list(want["mesh"]["2x2x1"]) == ["pod", "data", "model"]


def test_batch_slice_deals_rows_pod_major(reference, port4):
    tokens = reference[0]["tokens"]
    rows = STEP_BATCH // 4
    for rank, (_, meta) in enumerate(port4):
        # rank = pod * 2 + data on a (2, 2, 1) mesh: pod-major, as P(("pod",
        # "data")) deals the batch in the reference
        np.testing.assert_array_equal(np.asarray(meta["rows"]),
                                      tokens[rank * rows:(rank + 1) * rows])


@pytest.mark.parametrize("name", ["comp", "plain"])
def test_dp_step_matches_composed_reference_step(name, reference, port4):
    ref = reference[0]
    tol = TOLS["float32"]
    paths = [k[len("init/"):] for k in ref if k.startswith("init/")]
    init = {path: jnp.asarray(ref[f"init/{path}"]) for path in paths}
    opt = jax_opt.adamw(lr=LR)
    for rank, (got, _) in enumerate(port4):
        np.testing.assert_allclose(got[f"{name}/loss"], ref["loss"],
                                   atol=tol.fwd, rtol=tol.fwd)
        pod = rank // 2
        handed = {path: got[f"{name}/grads/{path}"] for path in paths}
        # the reference's AdamW on the gradient the step handed over
        want, _ = opt.apply({k: jnp.asarray(v) for k, v in handed.items()},
                            opt.init(init), init, 0)
        flips = 0
        for path in paths:
            g_ref = ref[f"{name}/grads/{path}"]
            if name == "comp":
                # the in-pod mean, before compression
                np.testing.assert_allclose(
                    got[f"inpod/{path}"], ref[f"inpod/{pod}/{path}"],
                    atol=tol.grad, rtol=tol.grad, err_msg=path)
                # handed over: the compression of those in-pod gradients,
                # bit for bit, with the residual the step returned
                np.testing.assert_array_equal(
                    handed[path], got[f"again/out/{path}"], err_msg=path)
                np.testing.assert_array_equal(
                    got[f"comp/err/{path}"], got[f"again/err/{path}"],
                    err_msg=path)
                # and the reference's within quanta: a scale moves by at
                # most max|Δ in-pod gradient| / 127, an unflipped output
                # by 127 times that; each pod's int8 value may flip
                d_in = max(np.abs(port4[r][0][f"inpod/{path}"]
                                  - ref[f"inpod/{r // 2}/{path}"]).max()
                           for r in range(4))
                smax = max(np.abs(ref[f"inpod/{p}/{path}"]).max()
                           for p in range(2)) / 127
                g_ref = ref[f"comp/out/{path}"][pod]
                assert_within_quanta(handed[path], g_ref, smax, 0.0,
                                     slack=d_in, what=f"{path} handed")
            else:                    # the global mean
                np.testing.assert_allclose(
                    handed[path], g_ref, atol=tol.grad, rtol=tol.grad,
                    err_msg=path)
            p_got = got[f"{name}/params/{path}"]
            np.testing.assert_allclose(p_got, np.asarray(want[path]),
                                       atol=1e-3 * LR, rtol=0, err_msg=path)
            # against the reference's step.  The first AdamW update is
            # u = g/(|g|+ε) after a common clip: where the two gradients
            # agree to 1% (r) it moves by at most r·lr (+ the clips'
            # difference); elsewhere by at most 2·lr, on few elements
            d_p = np.abs(p_got - ref[f"{name}/params/{path}"])
            agree = np.abs(handed[path] - g_ref) <= 0.01 * np.abs(g_ref)
            assert (d_p[agree] <= 0.02 * LR).all(), path
            assert (d_p <= 2 * LR + tol.grad).all(), path
            flips += int((~agree).sum())
        n = sum(ref[f"init/{path}"].size for path in paths)
        assert flips <= 0.01 * n, f"rank {rank}: {flips} of {n} disagree"
        # every replica holds the same parameters after the step
        for path in paths:
            np.testing.assert_array_equal(got[f"{name}/params/{path}"],
                                          port4[0][0][f"{name}/params/{path}"])


def test_compression_of_the_same_gradients_matches_reference(reference,
                                                             port4):
    """The reference's in-pod gradients through the port's compressor on
    the pod groups: the reference's output and residual, within the
    quanta of :func:`assert_within_quanta`."""
    ref = reference[0]
    for rank, (got, _) in enumerate(port4):
        pod = rank // 2
        for key in got:
            if not key.startswith("exact/"):
                continue
            what, path = key.split("/", 2)[1:]
            smax = max(np.abs(ref[f"inpod/{p}/{path}"]).max()
                       for p in range(2)) / 127
            quantum, ulps_of = ((smax / 2, 0.0) if what == "out"
                                else (2 * smax, 127 * smax))
            assert_within_quanta(got[key], ref[f"comp/{what}/{path}"][pod],
                                 quantum, ulps_of, what=key)


def test_dp_refusals(port4, reference):
    ref = reference[0]
    for _, meta in port4:
        assert meta["tp_plan"] == ["replica×2{split×2}", True]
        assert "does not divide" in meta["batch_refused"]
        np.testing.assert_allclose(meta["masked_loss"], ref["masked_loss"],
                                   atol=TOLS["float32"].fwd,
                                   rtol=TOLS["float32"].fwd)
        # a pipeline builds its mesh: the stage axis between pod and data
        assert list(meta["mesh"]["dp2_pp2"]) == ["stage", "data", "model"]
    for strat in (StrategySpec(pp=2), StrategySpec(dp=2, pp=2,
                                                   schedule="1f1b"),
                  StrategySpec(schedule="1f1b")):
        assert planner.compile_plan(None, None, strat).strategy == strat
    with pytest.raises(ValueError, match="unknown schedule"):
        planner.compile_plan(None, None, StrategySpec(schedule="zb"))
    # a model axis and ZeRO compile, and so do both beside a pipeline
    for strat in (StrategySpec(tp=2), StrategySpec(dp=2, zero=3),
                  StrategySpec(tp=2, pp=2)):
        assert planner.compile_plan(None, None, strat).strategy == strat
    # a caller's placement passes through, as in the reference
    assert planner.compile_plan(None, None, StrategySpec(pp=2),
                                placement=()).placement == ()


def test_make_mesh_checks_the_world(tmp_path):
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_mesh((1,), ("data",), device_type="cpu")
    assert port_mesh.mesh_axes("2x2x1") == ((2, 2, 1),
                                            ("pod", "data", "model"))
    with pytest.raises(ValueError, match="1 to 3"):
        port_mesh.mesh_axes("1x1x1x1")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="world has 1"):
            port_mesh.make_mesh((2,), ("data",), device_type="cpu")
        m = port_mesh.parse_mesh("1x1x1", device_type="cpu")
        assert port_mesh.mesh_shape(m) == {"pod": 1, "data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _seed_ckpt(directory, ref):
    """Step 0 of the reference's state with a zero error carry, written by
    the reference's manager: the port's driver resumes from it."""
    def nest(prefix):
        out = {}
        for path, v in _tree(ref, prefix).items():
            node = out
            *parents, leaf = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return out

    params = nest("init/")
    state = {"params": params, "opt": nest("drv/opt/"),
             "err": jax_gc.init_error_tree(params)}
    return JaxCheckpointManager(str(directory)).save(
        0, state, extra={"data": {"epoch": 0, "step": 0, "seed": 0}})


def test_train_driver_compressed_pod_of_one_matches_reference_and_resumes(
        tmp_path, reference):
    ref, meta, _ = reference
    assert meta["data"] == {"epoch": 0, "step": 0, "seed": 0}
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--mesh", "1x1x1", "--compress-pod"]
    _seed_ckpt(tmp_path / "a", ref)
    straight = train.main(argv + ["--steps", "3", "--ckpt-dir",
                                  str(tmp_path / "a")])
    assert straight["mesh"] == {"pod": 1, "data": 1, "model": 1}
    tol = TOLS["float32"]
    np.testing.assert_allclose(straight["losses"], meta["drv_losses"],
                               atol=tol.grad, rtol=tol.grad)
    _seed_ckpt(tmp_path / "b", ref)
    first = train.main(argv + ["--steps", "2", "--ckpt-dir",
                               str(tmp_path / "b")])
    rest = train.main(argv + ["--steps", "3", "--ckpt-dir",
                              str(tmp_path / "b")])
    assert first["final_step"] == 2 and rest["final_step"] == 3
    np.testing.assert_allclose(first["losses"] + rest["losses"],
                               straight["losses"], rtol=1e-6, atol=0)
    # the error carry is checkpointed with the state, and restored
    with open(tmp_path / "b" / "step_00000003" / "MANIFEST.json") as f:
        saved = json.load(f)["paths"]
    assert sum(p.startswith("err/") for p in saved) == 12 and \
        not dist.is_initialized()
    assert not [f for f in os.listdir(tmp_path / "b")
                if f.startswith(".filestore")]


def test_train_driver_refuses_later_slices(tmp_path):
    base = ["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    # a model axis trains under torchrun; a world of one cannot hold it
    for extra, words in ((["--mesh", "2x2"], "needs 4 ranks"),
                         (["--mesh", "1x2x2"], "needs 4 ranks: run it "
                                               "under torchrun"),
                         (["--pp", "2"], "needs a device count divisible "
                                         "by the stage count")):
        with pytest.raises(SystemExit, match=words):
            train.main(base + extra)
    with pytest.raises(SystemExit, match="torchrun"):
        train.main(base + ["--distributed"])
    # --auto is ported, but not beside a hand-made layout; the elastic
    # runtime's --hosts 2 needs a world of two hosts (the reference's words)
    for extra, words in ((["--auto", "--pp", "2"], "drop --mesh and --pp"),
                         (["--hosts", "2"], r"--hosts 2 must divide the "
                                            r"device count \(1\)")):
        with pytest.raises(SystemExit, match=words):
            train.main(base + extra)


def _torchrun(argv, tmp_path, nproc=4):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.train"]
        + argv, capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    return p.stdout


def test_torchrun_data_parallel_matches_one_device(tmp_path):
    """Four gloo ranks under torchrun on a 2x2x1 mesh: without compression
    the step's gradient is the global batch's, so the losses are the
    one-device run's; with it they stay close.  Rank 0 alone prints."""
    argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "32", "--log-every", "1"]
    one = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])["losses"]
    for extra in ([], ["--compress-pod"]):
        out = _torchrun(argv + ["--mesh", "2x2x1", "--ckpt-dir",
                                str(tmp_path / f"dp{len(extra)}")] + extra,
                        tmp_path)
        assert out.count("[done] step 3") == 1
        assert "'pod': 2, 'data': 2" in out and \
            ("int8 cross-pod" in out) == bool(extra)
        got = [float(line.split()[3]) for line in out.splitlines()
               if line.strip().startswith("step ")]
        # printed to 4 decimals; compression moves the later steps' loss
        # by far less than 1e-3 at this size
        tol = TOLS["float32"].grad if not extra else 1e-3
        np.testing.assert_allclose(got, one, atol=tol + 5e-5, rtol=tol)


# ---------------------------------------------------------------------------
# the compressed reduction over blocks: model shards and ZeRO (4 gloo ranks)
# ---------------------------------------------------------------------------

BLK_B, BLK_S = 8, 32           # the global batch of the block cases
BLK_STEPS = 3
ZEROS = (0, 1, 3)


def _blk_cfg():
    return dataclasses.replace(get_config(ARCH, smoke=True), n_kv_heads=2)


def _blk_plan(model, strat):
    from repro_torch.core.planner import mesh_for_strategy
    return planner.compile_plan(
        model, mesh_for_strategy(strat, pods=2, device_type="cpu"), strat,
        compress_pod=True)


def _spy_opt(seen: dict):
    """AdamW whose ``apply`` keeps the gradient it is handed at step 0."""
    opt = adamw(lr=LR)
    real_apply = opt.apply

    def apply(grads, state, p, step, **kw):
        if step == 0:
            seen["handed"] = {k: v.clone() for k, v in zip(*flatten(grads))}
        return real_apply(grads, state, p, step, **kw)

    return dataclasses.replace(opt, apply=apply)


def _np_state(tree) -> dict:
    return {k: v.detach().numpy().copy() for k, v in zip(*flatten(tree))}


def _blocks_main(rank: int, world: int, store: str, out_dir: str) -> None:
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core import sharding

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    cfg = _blk_cfg()
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (BLK_B, BLK_S)).astype(np.int32))
    res, meta = {}, {"losses": {}, "restored": {}}

    # ZeRO 0/1/3 at pod 2 x data 2, three compressed steps each
    plans, opts, whole = {}, {}, {}
    for z in ZEROS:
        model = Model(cfg, "cpu")
        strat = StrategySpec(dp=4, zero=z)
        plan = _blk_plan(model, strat)
        seen = {}
        opt = _spy_opt(seen)
        params = plan.init_params(0)
        state = {"params": params, "opt": plan.init_opt(opt, params),
                 "err": gc.init_error_tree(params)}
        step = plan.train_step_fn(opt, compress_pod=True)
        batch = plan.batch_slice({"tokens": tokens})
        losses = []
        for i in range(BLK_STEPS):
            p, o, m, e = step(state["params"], state["opt"], batch, i,
                              state["err"])
            state = {"params": p, "opt": o, "err": e}
            losses.append(float(m["loss"]))
        meta["losses"][str(z)] = losses
        meta[f"split{z}"] = {k: list(v.shape) for k, v in zip(*flatten(p))}
        handed = {k: sharding.gather_leaf(v, s, plan.rules)
                  for (k, v), s in zip(seen["handed"].items(),
                                       flatten(plan.param_specs)[1])}
        CheckpointManager(os.path.join(out_dir, f"z{z}"), rank=rank,
                          barrier=dist.barrier,
                          gather=lambda t, plan=plan, opt=opt:
                          plan.gather_state(t, opt)).save(BLK_STEPS, state)
        whole[z] = plan.gather_state(state, opt)
        plans[z], opts[z] = plan, opt
        if rank == 0:
            for k, v in handed.items():
                res[f"z{z}/handed/{k}"] = v.numpy()
            for k, v in _np_state(whole[z]).items():
                res[f"z{z}/state/{k}"] = v
    # every level's checkpoint restored into every other level's blocks
    for w in ZEROS:
        for r in ZEROS:
            ck = CheckpointManager(os.path.join(out_dir, f"z{w}"), rank=rank,
                                   barrier=dist.barrier)
            _, back, _ = plans[r].restore_state(ck, opts[r], with_err=True)
            got = plans[r].gather_state(back, opts[r])
            if rank == 0:
                a, b = flatten(got), flatten(whole[w])
                meta["restored"][f"{w}->{r}"] = a[0] == b[0] and all(
                    torch.equal(x, y) for x, y in zip(a[1], b[1]))

    # pod 2 x model 2: one compressed step; the in-pod gradients, the handed
    # gradient and the new error carry, gathered whole over model
    model = Model(cfg, "cpu")
    plan = _blk_plan(model, StrategySpec(dp=2, tp=2))
    specs = flatten(plan.param_specs)[1]
    seen = {}
    real_tree = gc.compressed_psum_tree

    def spy_tree(grads, group, err_tree, **kw):
        seen["inpod"] = {k: v.clone() for k, v in zip(*flatten(grads))}
        return real_tree(grads, group, err_tree, **kw)

    gc.compressed_psum_tree = spy_tree
    try:
        opt = _spy_opt(seen)
        params = plan.init_params(0)
        step = plan.train_step_fn(opt, compress_pod=True)
        out = step(params, plan.init_opt(opt, params),
                   plan.batch_slice({"tokens": tokens}), 0,
                   gc.init_error_tree(params))
    finally:
        gc.compressed_psum_tree = real_tree
    pod = plan.mesh.get_local_rank("pod")
    for what, tree in (("inpod", seen["inpod"]), ("handed", seen["handed"]),
                       ("err", dict(zip(*flatten(out[3]))))):
        for (k, v), s in zip(tree.items(), specs):
            v = sharding.gather_leaf(v, s, plan.rules)
            if plan.mesh.get_local_rank("model") == 0:
                res[f"tp/{pod}/{what}/{k}"] = v.detach().numpy()
    meta["tp_split"] = {k: list(v.shape) for k, v in zip(*flatten(params))}
    np.savez(os.path.join(out_dir, f"blk{rank}.npz"), **res)
    with open(os.path.join(out_dir, f"blk{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("blocks")
    mp.spawn(_blocks_main, args=(4, str(d / "store"), str(d)), nprocs=4,
             join=True)
    res = {}
    for r in (0, 2):                       # model rank 0 of each pod
        res.update(np.load(d / f"blk{r}.npz"))
    with open(d / "blk0.json") as f:
        return res, json.load(f)


def test_compressed_model_shards_match_reference_whole_leaves(blocks):
    """pod 2 × model 2: each rank compresses its model shard of every leaf.
    The pods' in-pod gradients, gathered whole, through the reference's
    ``compressed_psum_tree`` under ``jax.vmap`` over ``pod``: the handed
    gradient and the error carry agree within the quanta of
    :func:`assert_within_quanta` (the reference's scale is its whole
    leaf's abs-max)."""
    res, meta = blocks
    assert meta["tp_split"]["blocks/p0/attn/wq"][2] == 2     # half the heads
    paths = sorted({k.split("/", 3)[3] for k in res if k.startswith("tp/0/")})
    inpod = {p: jnp.stack([jnp.asarray(res[f"tp/{pod}/inpod/{p}"])
                           for pod in (0, 1)]) for p in paths}
    ref = jax.jit(jax.vmap(
        lambda g, e: jax_gc.compressed_psum_tree(g, "pod", e, mean=True),
        axis_name="pod"))
    out, err = ref(inpod, jax.tree.map(jnp.zeros_like, inpod))
    for p in paths:
        smax = max(np.abs(res[f"tp/{pod}/inpod/{p}"]).max()
                   for pod in (0, 1)) / 127
        for pod in (0, 1):
            assert_within_quanta(res[f"tp/{pod}/handed/{p}"],
                                 np.asarray(out[p][pod]), smax / 2, 0.0,
                                 what=f"{p} pod {pod} handed")
            assert_within_quanta(res[f"tp/{pod}/err/{p}"],
                                 np.asarray(err[p][pod]), 2 * smax,
                                 127 * smax, what=f"{p} pod {pod} err")


@pytest.mark.parametrize("zero", [1, 3])
def test_compressed_zero_equals_zero0_bit_for_bit(blocks, zero):
    """pod 2 × data 2: compressed ZeRO-1 (the parameter's block compressed,
    the optimizer on its slice) and ZeRO-3 (the data shard compressed)
    equal compressed ZeRO-0 bit for bit over three steps: losses, the
    step-0 handed gradient, and the gathered parameters, moments and error
    carry."""
    res, meta = blocks
    assert meta["losses"][str(zero)] == meta["losses"]["0"]
    for part in ("handed", "state"):
        want = {k: v for k, v in res.items() if k.startswith(f"z0/{part}/")}
        assert want
        for k, v in want.items():
            np.testing.assert_array_equal(
                res[k.replace("z0/", f"z{zero}/", 1)], v, err_msg=k)
    if zero == 3:
        split = meta["split3"]
        assert np.prod(split["embed/table"]) * 2 == np.prod(
            meta["split0"]["embed/table"])
    assert any(k.startswith("z0/state/err/") for k in res)


def test_error_carry_checkpoints_cross_zero_levels(blocks):
    """Each level's checkpoint (the reference's whole-leaf layout, the
    error carry one ``.npy`` a leaf) restores into every level's blocks
    and gathers back bit for bit."""
    _, meta = blocks
    assert len(meta["restored"]) == len(ZEROS) ** 2
    assert all(meta["restored"].values()), meta["restored"]


def test_torchrun_compressed_zero_trains_and_resumes_across_levels(tmp_path):
    """``--mesh 2x2x1 --compress-pod --zero N`` under torchrun on 4 gloo
    ranks: ZeRO-3's losses print as ZeRO-0's, and ZeRO-1 resumes ZeRO-3's
    checkpoint (the error carry in it) to ZeRO-0's next loss."""
    argv = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
            "--log-every", "1", "--mesh", "2x2x1", "--compress-pod"]

    def losses(out):
        return [line.split()[3] for line in out.splitlines()
                if line.strip().startswith("step ")]

    def run(zero, steps, ckpt):
        return _torchrun(argv + ["--steps", str(steps), "--zero", str(zero),
                                 "--ckpt-dir", str(tmp_path / ckpt)],
                         tmp_path)

    z0, z3 = run(0, 3, "z0"), run(3, 3, "z3")
    assert "zero=3: parameters, gradients and optimizer state over data" \
        in z3 and "int8 cross-pod" in z3
    assert losses(z3) == losses(z0) and len(losses(z0)) == 3
    # resumed under the same 4-step schedule: ZeRO-1 from ZeRO-3's state
    # and error carry, ZeRO-0 from its own
    z0, z1 = run(0, 4, "z0"), run(1, 4, "z3")
    assert "[resume] from step 3" in z1 and "[resume] from step 3" in z0
    assert losses(z1) == losses(z0) and len(losses(z0)) == 1
