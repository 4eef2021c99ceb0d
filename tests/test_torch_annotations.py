"""The port's annotation API (``import repro_torch as wh``) held against the
reference's (``import repro as wh``): the IR's meta capture (shapes,
dtypes and FLOPs with ``==``, on the reference's own cases and on the
smoke tinyllama's block), ``cluster_repeats`` and
``graph_from_taskgraph``, the recording rule of an eager ``wh.sub``, the
``Cluster``'s worlds, the package surface, the examples, and the slice as
a whole: the smoke tinyllama annotated at data 2 × model 2 and trained
through ``compile_nested_plan`` on 4 gloo ranks, against the reference's
unmeshed loss and AdamW loop (f32: values 2e-5, gradients 2e-4) and bit
for bit against the port's explicitly compiled plan.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from jax.sharding import AxisType

import repro
import repro as rwh
import repro_torch
import repro_torch as wh
from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.core import ir as ref_ir
from repro.core.auto import graph_from_taskgraph as ref_graph_from_taskgraph
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import transformer as ref_tfm
from repro.optim import optimizer as jax_opt
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import ir
from repro_torch.core.cost_model import StrategySpec
from repro_torch.core.planner import compile_plan
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw
from repro_torch.tree import flatten, tree_map

from torch_harness import TOLS, data

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"


def _dtype(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


def _metas(ts) -> list:
    return [(tuple(t.shape), _dtype(t.dtype)) for t in ts]


class StandInMesh:
    """What the annotation API reads of a ``DeviceMesh``: dim names and
    the grid of ranks."""

    def __init__(self, shape: tuple, names: tuple):
        self.mesh_dim_names = tuple(names)
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)


def _ref_mesh(names=("data", "model")):
    """The reference's one CPU device under ``names`` as ``Auto`` axes,
    whose sharding constraints jax 0.9 takes outside ``jit``."""
    return jax.make_mesh((1,) * len(names), names,
                         axis_types=(AxisType.Auto,) * len(names))


# ---------------------------------------------------------------------------
# the IR: capture_meta on the reference's cases, with ==
# ---------------------------------------------------------------------------

def _ref_scan7(x):
    def body(c, _):
        return c @ jnp.eye(16), None
    return jax.lax.scan(body, x, None, length=7)[0]


def _scan7(x):
    for _ in range(7):
        x = x @ torch.eye(16, device=x.device)
    return x


def _mlp(p, x, relu):
    return relu(x @ p["w1"]) @ p["w2"]


IR_CASES = {
    # name: (reference fn, port fn, numpy inputs)
    "matmul": (lambda x: x @ x.T, lambda x: x @ x.T,
               [np.ones((8, 4), np.float32)]),
    "scan7": (_ref_scan7, _scan7, [np.ones((16, 16), np.float32)]),
    "remat": (lambda x: jax.checkpoint(lambda y: y @ y)(x).sum(),
              lambda x: torch.utils.checkpoint.checkpoint(
                  lambda y: y @ y, x, use_reentrant=False).sum(),
              [np.ones((8, 8), np.float32)]),
    "mlp": (lambda p, x: _mlp(p, x, jax.nn.relu),
            lambda p, x: _mlp(p, x, torch.relu),
            [{"w1": np.ones((16, 32), np.float32),
              "w2": np.ones((32, 16), np.float32)},
             np.ones((4, 16), np.float32)]),
    "conv2d": (lambda x, w: jax.lax.conv_general_dilated(
                   x, w, (1, 1), "SAME"),
               lambda x, w: F.conv2d(x, w, padding=1),
               [np.ones((2, 3, 16, 16), np.float32),
                np.ones((8, 3, 3, 3), np.float32)]),
    "bf16_einsum": (lambda a, b: jnp.einsum("bqd,bkd->bqk", a, b),
                    lambda a, b: torch.einsum("bqd,bkd->bqk", a, b),
                    [np.ones((2, 5, 8), jnp.bfloat16),
                     np.ones((2, 7, 8), jnp.bfloat16)]),
}


def _to(tree, conv):
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    return conv(tree)


def _torch(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x)


@pytest.mark.parametrize("name", IR_CASES)
def test_capture_meta_matches_reference(name):
    ref_fn, fn, inputs = IR_CASES[name]
    want = ref_ir.capture_meta(ref_fn, *[_to(x, jnp.asarray)
                                         for x in inputs])
    got = ir.capture_meta(fn, *[_to(x, _torch) for x in inputs])
    assert _metas(got[0]) == _metas(want[0])
    assert _metas(got[1]) == _metas(want[1])
    assert got[2] == want[2] > 0
    assert all(t.device.type == "meta" for t in ir.tensor_leaves(got[3]))


def test_capture_meta_runs_nothing_on_the_inputs():
    seen = []

    def fn(x):
        seen.append(x.device.type)
        return x @ x.T

    x = torch.ones(8, 4)
    _, outputs, flops, out = ir.capture_meta(fn, x)
    assert seen == ["meta"] and out.device.type == "meta"
    assert outputs[0].shape == (8, 8) and flops == 2 * 8 * 8 * 4
    assert ir.graph_flops(_scan7, torch.ones(16, 16)) == 7 * 2 * 16 ** 3


def test_wrappers_take_their_plain_versions_on_meta_only_in_a_capture():
    from repro_torch.kernels.flash_attention import flash
    q, k, v = (torch.empty(s, device="meta")
               for s in ((1, 16, 4, 64), (1, 16, 2, 64), (1, 16, 2, 64)))
    with pytest.raises(ValueError):
        flash.flash_attention(q, k, v)
    n0 = flash.flash_attention.launches
    with kernels.abstract():
        o, lse = flash.flash_attention(q, k, v)
    assert o.device.type == "meta" and tuple(lse.shape) == (1, 16, 2, 2)
    assert flash.flash_attention.launches == n0
    with pytest.raises(ValueError):
        flash.flash_attention(q, k, v)


#: the block's width and inputs: the smoke config on arrays of numbers,
#: and tinyllama at full width on abstract ones (B, S, activation dtype)
BLOCKS = {"smoke": (True, 2, 32, np.float32),
          "full": (False, 4, 2048, jnp.bfloat16)}


def _block_inputs(name):
    """(the reference's cfg, model, block params, x, positions) and the
    port's (model, block params, x, positions) for ``BLOCKS[name]``."""
    smoke, B, S, dt = BLOCKS[name]
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=smoke),
                               attn_impl="ref")
    cfg = get_config(ARCH, smoke=smoke)
    jm = ref_lm.build(jcfg)
    if smoke:
        jp = jm.init(jax.random.key(0))
        jblock = jax.tree.map(lambda t: t[0], jp["blocks"]["p0"])
        model = Model(cfg, "cpu")
        block = tree_map(lambda t: t[0], model.init(0)["blocks"]["p0"])
        x = np.random.default_rng(0).standard_normal(
            (B, S, cfg.d_model)).astype(dt)
        pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
        return (jcfg, jm, jblock, jnp.asarray(x), jnp.asarray(pos), model,
                block, torch.from_numpy(x), torch.from_numpy(pos).long())
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    jblock = jax.tree.map(lambda t: jax.ShapeDtypeStruct(t.shape[1:],
                                                         t.dtype),
                          shapes["blocks"]["p0"])
    model = Model(cfg, "meta")
    block = tree_map(lambda t: t[0], model.param_shapes()["blocks"]["p0"])
    return (jcfg, jm, jblock, jax.ShapeDtypeStruct((B, S, cfg.d_model), dt),
            jax.ShapeDtypeStruct((B, S), jnp.int32), model, block,
            torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16,
                        device="meta"),
            torch.empty((B, S), dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("name", BLOCKS)
def test_block_capture_matches_reference_plain_path(name):
    """tinyllama's ``apply_block`` (smoke, and full width at 4 x 2048 in
    bf16): its plain path (the flash op's plain version on meta tensors)
    against the reference's ``ref`` attention path: shapes, parameter
    metas and FLOPs with ``==``.  The reference on its Pallas path counts
    the kernel's body once, not once per grid step: fewer FLOPs, printed
    (ROADMAP §C)."""
    jcfg, jm, jblock, jx, jpos, model, block, x, pos = _block_inputs(name)

    def ref_block(stack):
        return lambda p, h, q: ref_tfm.apply_block(
            p, h, q, stack.pattern[0], stack)[0]

    want = ref_ir.capture_meta(ref_block(jm.stack), jblock, jx, jpos)
    got = ir.capture_meta(
        lambda p, h, q: tfm.apply_block(p, h, q, model.stack.pattern[0])[0],
        block, x, pos)
    n = len(jax.tree.leaves(jblock))
    assert _metas(got[0][:n]) == _metas(want[0][:n])      # the parameters
    assert _metas(got[0][n:])[0] == _metas(want[0][n:])[0]
    assert _metas(got[1]) == _metas(want[1])
    assert got[2] == want[2]
    pallas = ref_lm.build(dataclasses.replace(jcfg, attn_impl="pallas"))
    kernel_path = ref_ir.capture_meta(ref_block(pallas.stack), jblock, jx,
                                      jpos)[2]
    print(f"block FLOPs: port {got[2]}, reference ref path {want[2]}, "
          f"reference Pallas path {kernel_path} (gap "
          f"{want[2] - kernel_path})")
    assert kernel_path < want[2]


# ---------------------------------------------------------------------------
# cluster_repeats and graph_from_taskgraph
# ---------------------------------------------------------------------------

def _toy(m, dtype):
    tg = m.TaskGraph()
    for i in range(5):
        tg.add(m.Subgraph(name=f"l{i}", fn=None, strategy=[],
                          params=[m.TensorMeta((64, 64), dtype)],
                          outputs=[m.TensorMeta((8, 64), dtype)]))
    tg.add(m.Subgraph(name="head", fn=None, strategy=[],
                      params=[m.TensorMeta((64, 1000), dtype)],
                      outputs=[m.TensorMeta((8, 1000), dtype)]))
    return tg


def _groups(tg) -> list:
    return [[n.name for n in g["nodes"]] for g in tg.cluster_repeats()]


def test_toy_graph_segments_match_reference():
    tg, rtg = _toy(ir, torch.float32), _toy(ref_ir, jnp.float32)
    assert _groups(tg) == _groups(rtg) == [[f"l{i}" for i in range(5)],
                                           ["head"]]
    got = wh.graph_from_taskgraph(tg, 8)
    want = ref_graph_from_taskgraph(rtg, 8)
    assert data(got) == data(want)
    assert data(got.workload_meta()) == data(want.workload_meta())
    assert got.workload_meta().batch == 8


def _trace_lm(W, L, jax_side: bool, params, tokens, stack):
    """The smoke tinyllama's forward as subgraphs: embed and the blocks
    under ``replica``, the final norm and head product under ``split``."""
    B, S = tokens.shape
    if jax_side:
        pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))

        def block(p, x, q):
            return ref_tfm.apply_block(p, x, q, stack.pattern[0], stack)[0]
        blocks = [jax.tree.map(lambda t, i=i: t[i], params["blocks"]["p0"])
                  for i in range(L)]
    else:
        pos = torch.arange(S)[None].expand(B, S)

        def block(p, x, q):
            return tfm.apply_block(p, x, q, stack.pattern[0])[0]
        blocks = [tree_map(lambda t, i=i: t[i], params["blocks"]["p0"])
                  for i in range(L)]
    lay = ref_layers if jax_side else layers
    with W.replica():
        x = W.sub("embed", lambda p, t: lay.embed(p, t))(params["embed"],
                                                          tokens)
        for i, bp in enumerate(blocks):
            x = W.sub(f"block{i}", block)(bp, x, pos)
    with W.split(dim=-1):
        return W.sub("head", lambda p, h: lay.rmsnorm(p["final_norm"], h)
                     @ p["head"]["w"])(
            {"final_norm": params["final_norm"], "head": params["head"]}, x)


def _traced_pair(tokens):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               n_layers=4, attn_impl="ref")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), n_layers=4)
    jm = ref_lm.build(jcfg)
    with rwh.cluster(mesh=_ref_mesh()) as rcl:
        _trace_lm(rwh, 4, True, jm.init(jax.random.key(0)),
                  jnp.asarray(tokens), jm.stack)
    model = Model(cfg, "cpu")
    with wh.cluster(mesh=StandInMesh((1, 1), ("data", "model"))) as cl:
        out = _trace_lm(wh, 4, False, model.init(0),
                        torch.from_numpy(tokens).long(), model.stack)
    return rcl, cl, out


def test_traced_tinyllama_segments_match_reference():
    tokens = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(
        np.int32)
    rcl, cl, _ = _traced_pair(tokens)
    assert _groups(cl.taskgraph) == _groups(rcl.taskgraph)
    assert [len(g) for g in _groups(cl.taskgraph)] == [1, 4, 1]
    for n, rn in zip(cl.taskgraph.nodes, rcl.taskgraph.nodes):
        assert (_metas(n.params), _metas(n.outputs), n.flops,
                n.strategy_kinds()) == (_metas(rn.params),
                                        _metas(rn.outputs), rn.flops,
                                        rn.strategy_kinds())
    got = wh.graph_from_taskgraph(cl.taskgraph, 2)
    want = ref_graph_from_taskgraph(rcl.taskgraph, 2)
    assert data(got) == data(want)
    assert data(wh.strategy_from_taskgraph(cl)) == \
        data(rwh.strategy_from_taskgraph(rcl))


# ---------------------------------------------------------------------------
# the recording rule of an eager wh.sub (ROADMAP §C)
# ---------------------------------------------------------------------------

def _net(p, x):
    return torch.tanh(x @ p["w"])


def _two(x, w):
    with wh.replica():
        h = wh.sub("a", _net)({"w": w}, x)
        return wh.sub("b", _net)({"w": w}, h)


def test_a_second_pass_replays_and_records_nothing():
    w, x = torch.ones(8, 8), torch.ones(4, 8)
    with wh.cluster(mesh=StandInMesh((1,), ("data",))) as cl:
        for _ in range(3):
            _two(x, w)
    assert [n.name for n in cl.taskgraph.nodes] == ["a", "b"]
    assert [s.n_layers for s in wh.graph_from_taskgraph(
        cl.taskgraph, 4).segments] == [2]


def test_a_name_twice_in_one_pass_or_reshaped_raises():
    w, x = torch.ones(8, 8), torch.ones(4, 8)
    with wh.cluster(mesh=StandInMesh((1,), ("data",))):
        with wh.replica():
            h = wh.sub("a", _net)({"w": w}, x)
            h = wh.sub("b", _net)({"w": w}, h)
            with pytest.raises(ValueError, match="already node 1"):
                wh.sub("b", _net)({"w": w}, h)
    with wh.cluster(mesh=StandInMesh((1,), ("data",))):
        _two(x, w)
        with pytest.raises(ValueError, match="other annotations, shapes"):
            _two(torch.ones(2, 8), w)


@pytest.mark.parametrize("thread", [False, True])
def test_a_checkpoint_recompute_records_nothing(thread):
    """The backward recomputes a checkpointed subgraph: on the caller's
    thread inside the scopes (the CPU's autograd) or on a thread of its
    own that sees an empty scope stack (the card's); neither records."""
    w = torch.ones(8, 8, requires_grad=True)
    x = torch.ones(4, 8)
    with wh.cluster(mesh=StandInMesh((1,), ("data",))) as cl:
        with wh.replica():
            y = torch.utils.checkpoint.checkpoint(
                wh.sub("blk", _net), {"w": w}, x, use_reentrant=False)
            if thread:
                out = []
                t = threading.Thread(target=lambda: out.append(
                    torch.autograd.grad(y.sum(), w)))
                t.start()
                t.join()
                (g,) = out[0]
            else:
                (g,) = torch.autograd.grad(y.sum(), w)
    assert [n.name for n in cl.taskgraph.nodes] == ["blk"]
    assert cl.taskgraph.nodes[0].strategy_kinds() == ("replica",)
    assert torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# the Cluster's worlds
# ---------------------------------------------------------------------------

def test_cluster_starts_and_ends_a_world_of_one():
    """A (1, 1) cluster with no process group starts a world of one
    (gloo on the CPU) and ``close`` ends it, so the next cluster starts
    its own; the reference's own Case 1/2 recording on it."""
    assert not dist.is_initialized()
    for _ in range(2):
        cl = wh.cluster(mesh_shape=(1, 1), axis_names=("data", "model"),
                        device_type="cpu")
        try:
            assert dist.is_initialized() and dist.get_backend() == "gloo"
            assert cl.shape == {"data": 1, "model": 1} and cl.n_devices == 1
            with cl:
                with wh.replica():
                    h = wh.sub("backbone", _net)({"w": torch.ones(4, 8)},
                                                 torch.ones(2, 4))
                with wh.split(dim=-1):
                    wh.sub("fc", _net)({"w": torch.ones(8, 16)}, h)
            assert cl.taskgraph.by_name("fc").params[0].shape == (8, 16)
            strat = wh.strategy_from_taskgraph(cl)
            assert strat.vocab_split and strat.dp == 1 and strat.tp == 1
            plan = wh.compile_plan_from_cluster(
                cl, Model(get_config(ARCH, smoke=True), "cpu"))
            assert plan.strategy == strat
        finally:
            cl.close()
        assert not dist.is_initialized()
    cl = wh.cluster(device_type="cpu")          # no shape: the world, data
    try:
        assert cl.shape == {"data": 1}
    finally:
        cl.close()


def test_cluster_refuses_what_it_cannot_build():
    with pytest.raises(RuntimeError, match="default process group"):
        wh.cluster(mesh_shape=(2, 2), axis_names=("data", "model"),
                   device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wh.cluster(mesh_shape=(1,))
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------

def test_surface_is_the_references_but_constrain():
    want = {n for n in dir(repro) if not n.startswith("_")
            and not isinstance(getattr(repro, n), types.ModuleType)}
    assert "constrain" in want and "sub" in want
    missing = want - {"constrain"} - set(dir(repro_torch))
    assert not missing, sorted(missing)
    assert not hasattr(repro_torch, "constrain")
    for name in ("cluster", "replica", "split", "stage", "pipeline", "sub",
                 "auto_scope", "auto_parallel", "TaskGraph", "capture_meta",
                 "compile_nested_plan", "compile_plan_from_cluster",
                 "strategy_from_taskgraph", "graph_from_taskgraph",
                 "model_graph"):
        assert hasattr(wh, name), name


def test_importing_the_port_builds_nothing_and_imports_no_jax():
    code = ("import sys; import repro_torch as wh; "
            "from repro_torch.kernels import build; "
            "assert build._lib is None; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.') or m == 'triton']; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    pattern = re.compile(r"^\s*(import jax|from jax\b|import repro\b"
                         r"|from repro\b(?!_torch)|import repro\.)", re.M)
    hits = [str(p) for p in (ROOT / "src" / "repro_torch").rglob("*.py")
            if pattern.search(p.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("name,last", [
    ("quickstart", "quickstart OK"),
    ("classification_split", "classification_split OK")])
def test_examples_run_on_the_cpu(name, last):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                          "--device", "cpu", "--steps", "2"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == last
    if name == "quickstart":
        assert any(line.startswith("[case 1] out (16, 8); recorded 1 "
                                   "subgraph(s): ['net']") for line in lines)
        losses = [float(line.split()[-1]) for line in lines
                  if line.startswith("[engine] step")]
        assert len(losses) == 2 and all(np.isfinite(losses))
    else:
        assert any("backbone→fc:all_gather" in line for line in lines)
        assert any(line.startswith("[fig5 headline]") for line in lines)


# ---------------------------------------------------------------------------
# the slice as a whole: 4 gloo ranks, data 2 x model 2
# ---------------------------------------------------------------------------

TOL = TOLS["float32"]
LR = 1e-3
B, T = 4, 32
STEPS = 2
WORLD = 4


def _cfg(get):
    return dataclasses.replace(get(ARCH, smoke=True), n_kv_heads=2,
                               vocab=500, remat="full")


def _np(tree) -> dict:
    return dict(zip(_leaf_paths(tree),
                    (np.asarray(x) for x in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def ref():
    """The reference's unmeshed loss, gradients and AdamW steps."""
    tokens = np.random.default_rng(0).integers(0, 500, (B, T)).astype(
        np.int32)
    jm = ref_lm.build(_cfg(jax_get_config))
    params = jm.init(jax.random.key(0))
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    batch = {"tokens": jnp.asarray(tokens)}
    opt = jax_opt.adamw(lr=LR)
    p, st, losses, grads = params, opt.init(params), [], None
    for i in range(STEPS):
        (loss, _), g = grad_fn(p, batch)
        grads = grads or _np(g)
        p, st = opt.apply(g, st, p, i)
        losses.append(float(loss))
    return {"tokens": tokens, "params": _np(params), "losses": losses,
            "grads": grads, "final": _np(p)}


def annotate(model, tokens):
    """The LM's forward as Whale subgraphs under replica{split}, on meta
    tensors (the kernels' plain versions, inside ``abstract()``)."""
    with kernels.abstract():
        _annotate(model, tokens)


def _annotate(model, tokens):
    cfg, (bcfg,) = model.cfg, model.stack.pattern
    params = model.param_shapes()
    B_, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None].expand(B_, S)
    with wh.replica():
        with wh.split(dim=-1):
            x = wh.sub("embed", lambda p, t: layers.embed(
                p, t, cfg.padded_vocab))(params["embed"], tokens)
            for i in range(cfg.n_layers):
                x = wh.sub(f"block{i}", lambda p, h, q: tfm.apply_block(
                    p, h, q, bcfg)[0])(tree_map(
                        lambda t, i=i: t[i], params["blocks"]["p0"]), x,
                        pos)
    with wh.replica():
        with wh.split(dim=-1):
            wh.sub("head", model.head_loss)(
                {"final_norm": params["final_norm"], "head": params["head"]},
                x, tokens, torch.ones((B_, S - 1), device=tokens.device))


def _train(plan, full, tokens) -> tuple:
    seen = {}
    opt = adamw(lr=LR)
    real_apply = opt.apply

    def apply(grads, *args, **kw):
        seen.setdefault("grads", tree_map(torch.clone, grads))
        return real_apply(grads, *args, **kw)

    opt = dataclasses.replace(opt, apply=apply)
    params = plan.shard(tree_map(torch.clone, full), plan.param_specs)
    state = plan.init_opt(opt, params)
    step = plan.train_step_fn(opt)
    batch = plan.batch_slice({"tokens": tokens})
    losses = []
    for i in range(STEPS):
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    return losses, params, seen["grads"], plan.gather_state(
        {"params": params}, adamw(lr=LR))


def _rank_main(rank: int, store: str, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    d = dict(np.load(inputs))
    cfg = _cfg(get_config)
    full = params_from_numpy(cfg, {k[2:]: v for k, v in d.items()
                                   if k.startswith("p/")}, "cpu")
    tokens = torch.tensor(d["tokens"])
    cl = wh.cluster(mesh_shape=(2, 2), axis_names=("data", "model"),
                    device_type="cpu")
    meta_model = Model(cfg, "meta")
    with cl:
        annotate(meta_model, torch.empty(tuple(tokens.shape),
                                         dtype=torch.int64, device="meta"))
    low = wh.lower(cl)
    plan = wh.compile_nested_plan(cl, Model(cfg, "cpu"))
    losses, params, grads, whole = _train(plan, full, tokens)
    strat = StrategySpec(dp=2, tp=2)
    explicit = compile_plan(Model(cfg, "cpu"), plan.mesh, strat)
    e_losses, e_params, e_grads, _ = _train(explicit, full, tokens)
    grads = tree_map(lambda g, s: _gather(g, s, plan), grads,
                     plan.param_specs)
    meta = {"strategy": data(plan.strategy), "describe": low.describe(),
            "nodes": len(cl.taskgraph.nodes), "losses": losses,
            "explicit_losses": e_losses,
            "same_params": all(torch.equal(a, b) for a, b in zip(
                flatten(params)[1], flatten(e_params)[1])),
            "same_grads": all(torch.equal(a, b) for a, b in zip(
                flatten(grads)[1], flatten(tree_map(
                    lambda g, s: _gather(g, s, plan), e_grads,
                    plan.param_specs))[1]))}
    if rank == 0:
        res = {f"grads/{k}": v.detach().numpy()
               for k, v in zip(*flatten(grads))}
        res.update({f"final/{k}": v.detach().numpy()
                    for k, v in zip(*flatten(whole["params"]))})
        np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def _gather(g, spec, plan):
    from repro_torch.core import sharding
    return sharding.gather_leaf(g, spec, plan.rules)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("wh4")
    np.savez(d / "inputs.npz", tokens=ref["tokens"],
             **{f"p/{k}": v for k, v in ref["params"].items()})
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


def test_annotated_plan_derives_the_hybrid(ranks):
    _, metas = ranks
    for m in metas:
        assert m["strategy"] == data(StrategySpec(dp=2, tp=2))
        assert m["nodes"] == 2 + _cfg(get_config).n_layers
        assert m["describe"].startswith("replica×2{split×2} | depth 2")


def test_annotated_plan_matches_reference(ranks, ref):
    res, metas = ranks
    for m in metas:
        np.testing.assert_allclose(m["losses"], ref["losses"], atol=TOL.fwd,
                                   rtol=TOL.fwd)
    for path, want in ref["grads"].items():
        np.testing.assert_allclose(res[f"grads/{path}"], want,
                                   atol=TOL.grad, rtol=TOL.grad,
                                   err_msg=path)
    for path, want in ref["final"].items():
        np.testing.assert_allclose(res[f"final/{path}"], want,
                                   atol=TOL.grad, rtol=TOL.grad,
                                   err_msg=path)


def test_annotated_plan_equals_the_explicit_plan_bit_for_bit(ranks):
    _, metas = ranks
    for m in metas:
        assert m["losses"] == m["explicit_losses"]
        assert m["same_params"] and m["same_grads"]
        assert m["losses"] == metas[0]["losses"]
