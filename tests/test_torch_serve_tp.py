"""Serving over a mesh in the port (``ExecutionPlan.state_specs``,
``paged_state_specs``, ``prefill_fn``, ``serve_step_fn``,
``serve_step_paged_fn``, ``Server(model, plan)`` and ``serve --mesh``)
against the reference (``repro``) on the CPU.

The state specs are held equal to the reference's with ``==`` on
``jax.sharding.AbstractMesh`` at tinyllama-1.1b's and mamba2-1.3b's full
widths, over data × model meshes 1×2, 2×2, 1×4 and 2×1, with a cache
length the model axis divides (the KV cache's sequence takes ``model``)
and one it does not (its kv heads take it).

One spawn of 2 gloo ranks (model 2) and one of 4 (data 2 × model 2) hold
the port's meshed functions against the reference's *unmeshed* ones on the
smoke tinyllama in f32 with 2 kv heads (so the attention is ``grouped`` at
tp 2), the weights carried across by ``models/convert.py``, within f32's
2e-5 (tests/torch_harness.py): the prefill's logits and cache; 8
teacher-forced steps of the dense decode from the reference's own prefill
state, sequence-split (24 rows) and head-split (23 rows), a whole cache
refused, and of the paged decode from pools built from its cache; and the Server's greedy
tokens for dense caches of both splits, a paged cache and a paged pool
tight enough to preempt, equal to the reference's unmeshed ``Server``.
Then the refusals, and the driver under ``torchrun``: ``--mesh 1x2`` and
``2x2`` complete every request with the tokens of the run without a mesh.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.core import planner as ref_planner
from repro.core.cost_model import StrategySpec as RefStrategySpec
from repro.models import lm as ref_lm
from repro.serving.server import Request as RefRequest
from repro.serving.server import Server as RefServer
from repro_torch.configs import get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.serving.server import Request, Server
from repro_torch.tree import flatten, tree_map

from torch_harness import TOLS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
TOL = TOLS["float32"].fwd
B, S = 4, 16                      # prefill batch and prompt bucket
LAST = [9, 15, 4, 12]             # each prompt's last real token
STEPS = 8                         # teacher-forced decode steps
DENSE_GB = {"seq": 8, "heads": 7}  # gen budgets: 24 rows split, 23 not
PS, MP, P = 4, 8, 29              # paged: page size, table width, pages
#: Server runs: name -> (cache, max_len, n_pages)
SERVERS = {"dense_seq": ("dense", 32, 0), "dense_heads": ("dense", 31, 0),
           "paged": ("paged", 32, 0), "paged_tight": ("paged", 32, 11)}
SPEC = [(6, 12), (9, 12), (12, 12), (5, 12), (7, 10), (3, 8)]
#: the spawns: name -> (data, model)
WORLDS = {"tp2": (1, 2), "dp2_tp2": (2, 2)}


def _cfg(get):
    return dataclasses.replace(get(ARCH, smoke=True), n_kv_heads=2)


def _drive(server, params, prompts, request) -> dict:
    """Every request of SPEC through ``server`` (either package's):
    {rid: (tokens, preemptions)}."""
    pending = [request(i, p.astype(np.int32), max_new=g)
               for i, (p, (_, g)) in enumerate(zip(prompts, SPEC))]
    done = []
    for _ in range(1000):
        if not (pending or server.active):
            break
        while (pending and (slot := server.free_slot()) is not None
               and server.can_admit(pending[0])):
            req = pending.pop(0)
            server.admit(params, req, slot)
            if req.done:
                done.append(req)
        done.extend(server.step(params))
        pending[:0] = server.take_requeued()
    else:
        raise AssertionError("drive did not converge")
    return {r.rid: ([int(t) for t in r.out_tokens], r.preemptions)
            for r in done}


def _paged_state(cache: np.ndarray, pos: np.ndarray):
    """Pools (L, P, PS, K, D) holding each live slot's prefill rows in
    scattered pages, with pages for STEPS more tokens, and its table;
    slot B-1 is inactive (table row 0, pos 0)."""
    rng = np.random.default_rng(7)
    free = list(rng.permutation(np.arange(1, P)))
    table = np.zeros((B, MP), np.int32)
    pool = np.zeros((cache.shape[0], P, PS) + cache.shape[3:], np.float32)
    for b in range(B - 1):
        n = -(-(pos[b] + STEPS) // PS)
        table[b, :n] = [free.pop() for _ in range(n)]
        for j in range(-(-S // PS)):
            pool[:, table[b, j]] = cache[:, b, j * PS:(j + 1) * PS]
    return pool, table


@pytest.fixture(scope="module")
def ref():
    """The reference's unmeshed prefill, dense and paged decode steps and
    Server on one weight set, and the inputs."""
    jm = ref_lm.build(_cfg(jax_get_config))
    jp = jm.init(jax.random.key(0))
    out = {"params": dict(zip(_leaf_paths(jp),
                              map(np.asarray, jax.tree.leaves(jp))))}
    rng = np.random.default_rng(0)
    V = jm.cfg.vocab
    out["tokens"] = rng.integers(0, V, (B, S)).astype(np.int32)
    out["steps"] = rng.integers(0, V, (STEPS, B)).astype(np.int32)
    out["prompts"] = [rng.integers(0, V, n) for n, _ in SPEC]
    step = jax.jit(jm.serve_step)
    for gb in sorted(set(DENSE_GB.values()) | {0}):
        logits, st = jm.prefill(jp, {"tokens": jnp.asarray(out["tokens"])},
                                gen_budget=gb, last_idx=jnp.asarray(LAST))
        out["prefill", gb] = (np.asarray(logits),
                              {k: np.asarray(v)
                               for k, v in st["cache"]["p0"].items()})
        if gb == 0:
            continue
        lg = []
        for t in range(STEPS):
            logits, st = step(jp, jnp.asarray(out["steps"][t]), st)
            lg.append(np.asarray(logits))
        out["dense", gb] = (np.stack(lg), {k: np.asarray(v) for k, v in
                                           st["cache"]["p0"].items()})
    pos = np.asarray(LAST, np.int32) + 1
    pos[-1] = 0
    cache = out["prefill", 0][1]
    pools, table = {}, None
    for key in ("k", "v"):
        pools[key], table = _paged_state(cache[key], pos)
    out["paged_in"] = (pools, table, pos)
    jstate = {"pools": {"p0": {k: jnp.asarray(v) for k, v in pools.items()}},
              "block_table": jnp.asarray(table), "pos": jnp.asarray(pos)}
    lg = []
    for t in range(STEPS):
        logits, jstate = jm.serve_step_paged(
            jp, jnp.asarray(out["steps"][t]), jstate)
        lg.append(np.asarray(logits))
        jstate["pos"] = jstate["pos"].at[B - 1].set(0)   # stays inactive
    out["paged"] = (np.stack(lg), {k: np.asarray(v) for k, v in
                                   jstate["pools"]["p0"].items()})
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    rplan = ref_planner.compile_plan(jm, mesh)
    for name, (cache, max_len, n_pages) in SERVERS.items():
        server = RefServer(jm, rplan, batch_slots=B, max_len=max_len,
                           cache=cache, page_size=PS, n_pages=n_pages)
        out["server", name] = _drive(server, jp, out["prompts"], RefRequest)
    return out


# ---------------------------------------------------------------------------
# the port on gloo ranks
# ---------------------------------------------------------------------------

def _gather_heads(tree: dict, plan) -> dict:
    """A prefill cache's leaves (L, B, S, K/tp, D) gathered to all heads."""
    return {k: sharding.gather_cat(v, plan.rules.group("model"), 3)
            for k, v in tree.items()}


def _rank_main(rank: int, world: str, store: str, inputs: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    shape = WORLDS[world]
    n = shape[0] * shape[1]
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    d = dict(np.load(inputs))
    cfg = _cfg(get_config)
    model = Model(cfg, "cpu")
    plan = planner.compile_plan(model, make_mesh(shape, ("data", "model"),
                                                 device_type="cpu"))
    full = params_from_numpy(cfg, {k[2:]: v for k, v in d.items()
                                   if k.startswith("p/")}, "cpu")
    params = model.serving_params(plan.shard(full, plan.param_specs))
    lo, hi = plan.slot_block(B)
    res, meta = {}, {"slots": [lo, hi]}
    steps = torch.tensor(d["steps"]).long()

    for gb in sorted(set(DENSE_GB.values()) | {0}):
        logits, st = plan.prefill_fn(gb)(
            params, {"tokens": torch.tensor(d["tokens"])},
            last_idx=torch.tensor(LAST))
        res[f"prefill{gb}/logits"] = logits.numpy()
        for k, v in _gather_heads(st["cache"]["p0"], plan).items():
            res[f"prefill{gb}/{k}"] = v.numpy()

    for name, gb in DENSE_GB.items():
        specs = plan.state_specs(B, S + gb)
        full_state = {"cache": {"p0": {k: torch.tensor(d[f"dense{gb}/{k}"])
                                       for k in ("k", "v")}},
                      "pos": torch.tensor(LAST, dtype=torch.int32) + 1}
        state = tree_map(lambda x, s: sharding.shard_leaf(x, s, plan.rules),
                         full_state, specs)
        meta[f"dense_{name}_spec"] = list(specs["cache"]["p0"]["k"])
        step = plan.serve_step_fn(B, S + gb)
        lg = []
        for t in range(STEPS):
            logits, state = step(params, steps[t, lo:hi], state)
            lg.append(plan.gather_slots(logits))
        res[f"dense_{name}/logits"] = torch.stack(lg).numpy()
        for path, v, s in zip(*flatten(state["cache"]),
                              flatten(specs["cache"])[1]):
            res[f"dense_{name}/{path}"] = sharding.gather_leaf(
                v, s, plan.rules).numpy()

    # a whole cache under the model split is neither layout: it raises
    shapes = model.decode_state_shapes(hi - lo, S + DENSE_GB["heads"])
    whole = tree_map(lambda sd: torch.zeros(sd[0], dtype=sd[1]), shapes)
    try:
        plan.serve_step_fn(B, S + DENSE_GB["heads"])(params, steps[0, lo:hi],
                                                     whole)
    except ValueError as e:
        meta["whole_cache_refused"] = str(e)

    specs = plan.paged_state_specs(B, P, PS, MP)
    meta["paged_spec"] = list(specs["pools"]["p0"]["k"])
    pools = {"p0": {k: sharding.shard_leaf(torch.tensor(d[f"pool/{k}"]),
                                           specs["pools"]["p0"][k],
                                           plan.rules) for k in ("k", "v")}}
    pos = d["paged_pos"].copy()
    step = plan.serve_step_paged_fn(B, P, PS, MP)
    lg = []
    for t in range(STEPS):
        state = {"pools": pools,
                 "block_table": torch.tensor(d["table"][lo:hi]),
                 "pos": torch.tensor(pos[lo:hi])}
        logits, _ = step(params, steps[t, lo:hi], state)
        lg.append(plan.gather_slots(logits))
        pos[:B - 1] += 1
    res["paged/logits"] = torch.stack(lg).numpy()
    # each data rank wrote only its slots' pages: sum the owners' pages
    own = torch.zeros(P, dtype=torch.bool)
    own[torch.tensor(d["table"][lo:hi]).long().flatten()] = True
    meta["others_untouched"] = True
    for k in ("k", "v"):
        pool = sharding.gather_leaf(pools["p0"][k], specs["pools"]["p0"][k],
                                    plan.rules)
        before = torch.tensor(d[f"pool/{k}"])
        meta["others_untouched"] &= torch.equal(pool[:, ~own],
                                                before[:, ~own])
        pool = pool * own[None, :, None, None, None]
        res[f"paged/{k}"] = sharding.all_reduce_(
            pool, plan.mesh.get_group("data")).numpy()

    prompts = [d[f"prompt{i}"] for i in range(len(SPEC))]
    for name, (cache, max_len, n_pages) in SERVERS.items():
        server = Server(model, plan, batch_slots=B, max_len=max_len,
                        cache=cache, page_size=PS, n_pages=n_pages)
        meta["server", name] = _drive(server, params, prompts, Request)
        if cache == "paged":
            meta["trash_zero", name] = all(
                not kv[k][:, 0].any() for kv in server.pools.values()
                for k in ("k", "v"))
            meta["pool_shape", name] = list(server.pools["p0"]["k"].shape)
        else:
            meta["cache_shape", name] = list(
                server.state["cache"]["p0"]["k"].shape)
    try:
        Server(model, plan, batch_slots=3, max_len=32)
    except ValueError as e:
        meta["slots_refused"] = str(e)
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"|".join(map(str, k)) if isinstance(k, tuple) else k: v
                   for k, v in meta.items()}, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=list(WORLDS))
def ranks(request, ref, tmp_path_factory):
    import torch.multiprocessing as mp
    world = request.param
    n = WORLDS[world][0] * WORLDS[world][1]
    d = tmp_path_factory.mktemp(world)
    pools, table, pos = ref["paged_in"]
    arrays = {"tokens": ref["tokens"], "steps": ref["steps"],
              "table": table, "paged_pos": pos,
              **{f"p/{k}": v for k, v in ref["params"].items()},
              **{f"prompt{i}": p for i, p in enumerate(ref["prompts"])},
              **{f"pool/{k}": v for k, v in pools.items()}}
    for gb in DENSE_GB.values():
        for k, v in ref["prefill", gb][1].items():
            arrays[f"dense{gb}/{k}"] = v
    np.savez(d / "inputs.npz", **arrays)
    ctx = mp.start_processes(
        _rank_main, args=(world, str(d / "store"), str(d / "inputs.npz"),
                          str(d)), nprocs=n, join=False,
        start_method="spawn")
    for p in ctx.processes:
        p.join(240)
    alive = [p for p in ctx.processes if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank did not finish within 240 s"
    assert ctx.join(), "the ranks did not exit"
    metas = []
    for r in range(n):
        with open(d / f"rank{r}.json") as f:
            metas.append(json.load(f))
    return world, dict(np.load(d / "rank0.npz")), metas


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=msg)


def test_prefill_matches_reference(ranks, ref):
    """Logits gathered over the vocab split, and the cache (each rank's kv
    heads, gathered) at gen budgets 0, 7 and 8."""
    _, res, _ = ranks
    for gb in sorted(set(DENSE_GB.values()) | {0}):
        logits, cache = ref["prefill", gb]
        _close(res[f"prefill{gb}/logits"], logits, f"gb {gb} logits")
        for k, v in cache.items():
            assert res[f"prefill{gb}/{k}"].shape == v.shape
            _close(res[f"prefill{gb}/{k}"], v, f"gb {gb} {k}")


@pytest.mark.parametrize("name", list(DENSE_GB))
def test_dense_steps_match_reference(ranks, ref, name):
    """8 teacher-forced dense steps from the reference's prefill state:
    24 rows split the sequence over model (the merged softmax), 23 split
    the kv heads; every step's logits and the final cache."""
    world, res, metas = ranks
    gb = DENSE_GB[name]
    want_logits, want_cache = ref["dense", gb]
    _close(res[f"dense_{name}/logits"], want_logits, "logits")
    for k, v in want_cache.items():
        _close(res[f"dense_{name}/p0/{k}"], v, k)
    seq, heads = ("model", None) if name == "seq" else (None, "model")
    assert metas[0][f"dense_{name}_spec"] == [None, "data", seq, heads,
                                              None]


def test_dense_decode_refuses_a_cache_of_neither_layout(ranks):
    """The dense decode takes its layout from the state spec, not from the
    cache's shape: a whole cache under the model split (neither this
    rank's rows nor its kv heads) raises on every rank."""
    _, _, metas = ranks
    assert all("head-split cache holds 1 kv heads a rank, got 2"
               in m.get("whole_cache_refused", "") for m in metas)


def test_paged_steps_match_reference(ranks, ref):
    """8 teacher-forced paged steps (three live slots in scattered pages,
    an inactive one) on each rank's kv heads: the live slots' logits, the
    pools gathered (each page from its slot's data rank), the trash page
    zero; no rank wrote a page of another data rank's slots."""
    _, res, metas = ranks
    assert all(m["others_untouched"] for m in metas)
    want_logits, want_pools = ref["paged"]
    _close(res["paged/logits"][:, :B - 1], want_logits[:, :B - 1], "logits")
    for k, v in want_pools.items():
        _close(res[f"paged/{k}"], v, k)
        assert not res[f"paged/{k}"][:, 0].any()
    assert metas[0]["paged_spec"] == [None, None, None, "model", None]


@pytest.mark.parametrize("name", list(SERVERS))
def test_server_tokens_match_reference(ranks, ref, name):
    """The Server over the mesh gives every request the reference
    Server's tokens and preemptions, on every rank; each rank holds its
    slots (and, for a split sequence, its rows or, else, its heads)."""
    world, _, metas = ranks
    dp, tp = WORLDS[world]
    want = {str(rid): [toks, pre] for rid, (toks, pre)
            in ref["server", name].items()}
    for m in metas:
        assert m[f"server|{name}"] == want
    if name == "paged_tight":
        assert sum(pre for _, pre in want.values()) > 0, \
            "the tight pool never preempted"
    cache, max_len, _ = SERVERS[name]
    if cache == "paged":
        assert all(m[f"trash_zero|{name}"] for m in metas)
        assert metas[0][f"pool_shape|{name}"][3] == 2 // tp
    elif name == "dense_seq":
        assert metas[0][f"cache_shape|{name}"][1:4] == [B // dp,
                                                        max_len // tp, 2]
    else:
        assert metas[0][f"cache_shape|{name}"][1:4] == [B // dp, max_len,
                                                        2 // tp]


def test_slots_split_over_data(ranks):
    """Each data rank holds its block of the slots; slots the data axes do
    not divide are refused."""
    world, _, metas = ranks
    dp = WORLDS[world][0]
    blocks = sorted({tuple(m["slots"]) for m in metas})
    assert blocks == [(i * B // dp, (i + 1) * B // dp) for i in range(dp)]
    if dp > 1:
        assert all("do not divide" in m["slots_refused"] for m in metas)
    else:
        assert all("slots_refused" not in m for m in metas)


# ---------------------------------------------------------------------------
# the specs against the reference's, and the refusals (no ranks)
# ---------------------------------------------------------------------------

MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4), "2x1": (2, 1)}


def _plans(arch: str, mesh: str):
    sizes = MESHES[mesh]
    axes = ("data", "model")
    shape = dict(zip(axes, sizes))
    rplan = ref_planner.compile_plan(
        ref_lm.build(jax_get_config(arch)), AbstractMesh(sizes, axes),
        RefStrategySpec(dp=sizes[0], tp=sizes[1]))
    strat = StrategySpec(dp=sizes[0], tp=sizes[1])
    plan = planner.ExecutionPlan(
        model=Model(get_config(arch), "meta"), mesh=None, strategy=strat,
        rules=sharding.rules_for_strategy(shape, strat))
    return rplan, plan


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("cache_len", [1024, 1023])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", [ARCH, "mamba2-1.3b"])
def test_state_specs_match_reference(arch, mesh, cache_len):
    """``state_specs`` at the full width equal the reference's with
    ``==``: a cache length the model axis divides splits the sequence,
    1023 falls back to the kv heads; mamba2's state splits its heads."""
    rplan, plan = _plans(arch, mesh)
    got = plan.state_specs(8, cache_len)
    assert got == _specs(rplan.state_specs(8, cache_len))
    if arch == ARCH:
        # a model axis of one divides every length
        want = ("model", None) if cache_len % MESHES[mesh][1] == 0 \
            else (None, "model")
        assert got["cache"]["p0"]["k"][2:4] == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_paged_state_specs_match_reference(mesh):
    rplan, plan = _plans(ARCH, mesh)
    args = (8, 129, 64, 16)
    assert plan.paged_state_specs(*args) == _specs(
        rplan.paged_state_specs(*args))


@pytest.mark.parametrize("arch", [ARCH, "mamba2-1.3b"])
def test_state_shapes_match_reference(arch):
    """The port's templates hold the reference's shapes and dtypes, and
    allocate nothing."""
    jm, tm = ref_lm.build(jax_get_config(arch)), Model(get_config(arch),
                                                       "meta")
    pairs = [(tm.decode_state_shapes(8, 1024),
              jm.decode_state_shapes(8, 1024))]
    if arch == ARCH:
        pairs.append((tm.paged_state_shapes(8, 129, 64, 16),
                      jm.paged_state_shapes(8, 129, 64, 16)))
    for got, want in pairs:
        paths, leaves = flatten(got)
        assert paths == _leaf_paths(want)
        for (shape, dtype), w in zip(leaves, jax.tree.leaves(want)):
            assert tuple(shape) == w.shape
            assert str(dtype).removeprefix("torch.") == str(w.dtype)


def _refusal(case: str):
    cfg = get_config(ARCH, smoke=True)
    strat = {"pipeline": StrategySpec(dp=2, pp=2),
             "repeat": StrategySpec(tp=2),
             "zero3": StrategySpec(dp=2, zero=3)}[case]
    shape = {"data": strat.dp, "model": strat.tp}
    if strat.pp > 1:
        shape = {"stage": strat.pp, **shape}
    plan = planner.ExecutionPlan(
        model=Model(cfg, "cpu"), mesh=None, strategy=strat,
        rules=sharding.rules_for_strategy(shape, strat))
    return plan


@pytest.mark.parametrize("case,item", [("pipeline", "item 4"),
                                       ("repeat", "item 4"),
                                       ("zero3", "item 4")])
def test_serving_refusals_name_their_item(case, item):
    """Serving inside a pipeline, the ``repeat`` layout (the smoke's one
    kv head at tp 2) and ZeRO-3's data-sharded parameters raise, naming
    their ROADMAP item; only the decode steps refuse the layout (the
    prefill is the training attention's).  mamba2 over a model axis serves
    (tests/test_torch_ssm_tp.py)."""
    plan = _refusal(case)
    with pytest.raises(NotImplementedError, match=f"queue A {item}"):
        plan.serve_step_fn(4, 32)
    if plan.model.supports_paged:
        with pytest.raises(NotImplementedError, match=f"queue A {item}"):
            plan.serve_step_paged_fn(4, 9, 4, 8)
    if case == "repeat":
        plan.prefill_fn(0)
    else:
        with pytest.raises(NotImplementedError, match=f"queue A {item}"):
            plan.prefill_fn(0)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

DRIVER = ["--smoke", "--device", "cpu", "--requests", "8", "--batch-slots",
          "4", "--prompt-len", "9", "--gen", "6", "--max-len", "32",
          "--page-size", "4", "--overrides", "n_kv_heads=2"]


def _torchrun(n: int, argv: list, cwd) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "-m", "repro_torch.launch.serve"] + argv,
        capture_output=True, text=True, timeout=300, env=env, cwd=str(cwd))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    return p.stdout


@pytest.mark.parametrize("mesh,extra", [
    ("1x2", ["--cache", "dense"]),
    ("2x2", ["--cache", "paged", "--pages", "12"]),
])
def test_driver_over_mesh_gives_the_unmeshed_tokens(mesh, extra, tmp_path):
    """``serve --mesh`` under ``torchrun`` completes every request with
    the run without a mesh's tokens (their CRC-32); rank 0 alone prints."""
    want = serve.main(DRIVER + extra)
    out = _torchrun(int(np.prod([int(x) for x in mesh.split("x")])),
                    DRIVER + extra + ["--mesh", mesh], tmp_path)
    dp, tp = mesh.split("x")
    assert f"[plan] mesh {{'data': {dp}, 'model': {tp}}}; split×{tp} " \
        f"over model (heads, MLP columns, vocab)" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve/")]
    assert len(lines) == 1 and "8 requests completed" in lines[0]
    assert re.search(rf"tokens crc32 {want['tokens_crc32']:08x}\)", lines[0])


def test_driver_mesh_outside_torchrun(monkeypatch):
    """A mesh of two outside ``torchrun`` exits naming the ranks it needs;
    ``--mesh 1x1`` is a world of one with the unmeshed tokens; without a
    card and without ``--device cpu`` it raises."""
    with pytest.raises(SystemExit, match="needs 2 ranks"):
        serve.main(DRIVER + ["--mesh", "1x2"])
    one = serve.main(DRIVER + ["--mesh", "1x1"])
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["tokens_crc32"] == serve.main(DRIVER)["tokens_crc32"]
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--mesh", "1x1"])
