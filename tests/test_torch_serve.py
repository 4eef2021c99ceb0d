"""The port's serving slice (``repro_torch``) against the reference
(``repro``): the JAX model's unmeshed ``prefill`` / ``serve_step`` /
``serve_step_paged`` on the same weights (bridged with
``params_from_numpy``) and the same numpy inputs, then the port's Server
and driver end to end.

Two configs: the tinyllama smoke config (GQA 4:1) and a variant with
8 query heads over 2 kv heads, so kv-head indexing is exercised with K>1.
Logits and KV after the whole stack agree within 1e-4 (f32).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.configs.base import shrink as jax_shrink
from repro.models.lm import Model as JaxModel
from repro_torch.configs import get_config, shrink
from repro_torch.launch import serve, train
from repro_torch.models.convert import leaf_paths, params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.serving.server import Request, Server, prompt_bucket

ARCH = "tinyllama-1.1b"
TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _configs(which: str):
    if which == "smoke":
        return jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    return (jax_shrink(jax_get_config(ARCH), n_heads=8, n_kv_heads=2),
            shrink(get_config(ARCH), n_heads=8, n_kv_heads=2))


@pytest.fixture(scope="module", params=["smoke", "gqa8x2"])
def pair(request):
    """(jax model, jax params, port model, port params) on one weight set."""
    jcfg, tcfg = _configs(request.param)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tree = dict(zip(_leaf_paths(jp), map(np.asarray, jax.tree.leaves(jp))))
    tm = Model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(tcfg, tree, "cpu")


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


def _prefill_both(pair, tokens, last_idx, gen_budget):
    jm, jp, tm, tp = pair
    want = jm.prefill(jp, {"tokens": jnp.asarray(tokens)},
                      gen_budget=gen_budget, last_idx=jnp.asarray(last_idx))
    got = tm.prefill(tp, {"tokens": torch.tensor(tokens)},
                     gen_budget=gen_budget, last_idx=torch.tensor(last_idx))
    return got, want


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


# ---------------------------------------------------------------------------
# model functions vs the reference
# ---------------------------------------------------------------------------

def test_prefill_matches_reference(pair):
    tokens = _tokens(pair[2].cfg, (2, 16))
    (logits, st), (jlogits, jst) = _prefill_both(pair, tokens, [9, 15], 8)
    _close(logits, jlogits)
    np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(jst["pos"]))
    for key in ("k", "v"):
        assert st["cache"]["p0"][key].shape == jst["cache"]["p0"][key].shape
        _close(st["cache"]["p0"][key], jst["cache"]["p0"][key])


def test_serve_step_matches_reference(pair):
    jm, jp, tm, tp = pair
    tokens = _tokens(tm.cfg, (2, 16), seed=1)
    (_, st), (_, jst) = _prefill_both(pair, tokens, [4, 15], 8)
    for step in range(3):
        nxt = _tokens(tm.cfg, (2,), seed=10 + step)
        logits, st = tm.serve_step(tp, torch.tensor(nxt), st)
        jlogits, jst = jm.serve_step(jp, jnp.asarray(nxt, jnp.int32), jst)
        _close(logits, jlogits)
    np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(jst["pos"]))
    for key in ("k", "v"):
        _close(st["cache"]["p0"][key], jst["cache"]["p0"][key])


def test_serve_step_paged_matches_reference(pair):
    """Two live slots with scattered pages plus an inactive slot (block
    table row 0, pos 0): logits and pools agree, and the port leaves the
    trash page zero."""
    jm, jp, tm, tp = pair
    ps, mp, P = 4, 8, 17
    tokens = _tokens(tm.cfg, (3, 16), seed=2)
    last = [9, 15, 0]
    (_, st), _ = _prefill_both(pair, tokens, last, 0)
    table = np.zeros((3, mp), np.int32)
    table[0, :4] = [3, 7, 1, 6]
    table[1, :5] = [2, 9, 4, 5, 8]
    pools = {}
    for key in ("k", "v"):
        cache = st["cache"]["p0"][key].numpy()      # (L, 3, 16, K, D)
        pool = np.zeros((cache.shape[0], P, ps) + cache.shape[3:], np.float32)
        for b in (0, 1):
            for j in range(4):
                pool[:, table[b, j]] = cache[:, b, j * ps:(j + 1) * ps]
        pools[key] = pool
    pos = np.array([10, 16, 0], np.int32)
    tstate = {"pools": {"p0": {k: torch.tensor(v) for k, v in pools.items()}},
              "block_table": torch.tensor(table), "pos": torch.tensor(pos)}
    jstate = {"pools": {"p0": {k: jnp.asarray(v) for k, v in pools.items()}},
              "block_table": jnp.asarray(table), "pos": jnp.asarray(pos)}
    for step in range(3):
        nxt = _tokens(tm.cfg, (3,), seed=20 + step)
        logits, tstate = tm.serve_step_paged(tp, torch.tensor(nxt), tstate)
        jlogits, jstate = jm.serve_step_paged(jp, jnp.asarray(nxt, jnp.int32),
                                              jstate)
        _close(logits[:2], jlogits[:2])
        # the inactive slot stays at pos 0, as the server keeps it
        jstate["pos"] = jstate["pos"].at[2].set(0)
        tstate["pos"][2] = 0
    for key in ("k", "v"):
        _close(tstate["pools"]["p0"][key], jstate["pools"]["p0"][key])
        assert not tstate["pools"]["p0"][key][:, 0].any()


# ---------------------------------------------------------------------------
# the Server end to end vs a reference greedy loop
# ---------------------------------------------------------------------------

MAX_LEN = 32
SPEC = [(6, 12), (9, 12), (12, 12), (5, 12)]      # (prompt length, max_new)


@pytest.fixture(scope="module")
def reference_tokens(pair):
    """Greedy tokens per request from the reference model at batch 1:
    bucketed ``prefill`` (gen_budget = max_len - bucket, as the dense
    server's slots) then ``serve_step`` until EOS or ``max_new``."""
    jm, jp, tm, _ = pair
    prompts = [_tokens(tm.cfg, (n,), seed=30 + i) for i, (n, _) in
               enumerate(SPEC)]
    step = jax.jit(jm.serve_step)
    prefills = {}
    out = []
    for prompt, (n, max_new) in zip(prompts, SPEC):
        bucket = prompt_bucket(n, MAX_LEN)
        if bucket not in prefills:
            prefills[bucket] = jax.jit(
                lambda p, t, li, gb=MAX_LEN - bucket: jm.prefill(
                    p, {"tokens": t}, gen_budget=gb, last_idx=li))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = prompt
        logits, st = prefills[bucket](jp, jnp.asarray(padded),
                                      jnp.asarray([n - 1], jnp.int32))
        toks = [int(jnp.argmax(logits[0, :jm.cfg.vocab]))]
        while toks[-1] != 1 and len(toks) < max_new:
            logits, st = step(jp, jnp.asarray(toks[-1:], jnp.int32), st)
            toks.append(int(jnp.argmax(logits[0, :jm.cfg.vocab])))
        out.append(toks)
    return prompts, out


def _drive(server: Server, params, prompts) -> dict:
    pending = [Request(i, p.astype(np.int32), max_new=g)
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
    return {r.rid: r for r in done}


@pytest.mark.parametrize("cache,n_pages", [("dense", 0), ("paged", 0),
                                           ("paged", 11)])
def test_server_tokens_match_reference_loop(pair, reference_tokens, cache,
                                            n_pages):
    """Dense, paged, and paged with a pool too tight for every slot (10
    usable pages of 4 rows for 3 slots): preemption and restart still
    give each request the reference's greedy tokens."""
    _, _, tm, tp = pair
    prompts, want = reference_tokens
    server = Server(tm, batch_slots=3, max_len=MAX_LEN, cache=cache,
                    page_size=4, n_pages=n_pages)
    got = _drive(server, tp, prompts)
    assert sorted(got) == list(range(len(SPEC)))
    for rid, toks in enumerate(want):
        assert got[rid].out_tokens == toks, f"request {rid} diverged"
    if n_pages:
        assert sum(r.preemptions for r in got.values()) > 0, \
            "tight pool never preempted — the scenario lost its point"
    if cache == "paged":
        for kv in server.pools.values():
            assert not kv["k"][:, 0].any() and not kv["v"][:, 0].any()


def test_server_rejects_bad_geometry(pair):
    tm = pair[2]
    with pytest.raises(ValueError):
        Server(tm, batch_slots=2, max_len=30, cache="paged", page_size=8)
    with pytest.raises(ValueError):
        Server(tm, batch_slots=2, max_len=32, cache="nope")


# ---------------------------------------------------------------------------
# the driver, the weight bridge, isolation from JAX, no CPU fallback
# ---------------------------------------------------------------------------

SMOKE_CPU = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "6",
             "--batch-slots", "3", "--prompt-len", "9", "--gen", "5",
             "--max-len", "32"]


@pytest.mark.parametrize("extra", [
    [],
    ["--cache", "paged", "--page-size", "8"],
    ["--traffic", "--cache", "paged", "--page-size", "8", "--pages", "6",
     "--rate", "200"],
])
def test_serve_driver_completes_every_request(extra):
    s = serve.main(SMOKE_CPU + extra)
    assert s["completed"] == 6
    assert s["tokens"] >= 6 and s["steps"] > 0


@pytest.mark.parametrize("arch", [ARCH, "mamba2-1.3b", "deepseek-moe-16b",
                                  "qwen2-vl-2b", "seamless-m4t-medium"])
def test_bridge_maps_every_leaf_of_the_full_config(arch):
    """``params_from_numpy`` on the full config's shapes (tinyllama-1.1b;
    mamba2-1.3b, tied, so no ``head`` leaf; deepseek-moe-16b, its router
    in f32; qwen2-vl-2b, tied, with ``adapter/{w,b}``; seamless-m4t-medium,
    ``encdec/encoder/…``, ``encdec/decoder/…/cross_attn/…``, the adapter
    and its untied ``head``), from ``jax.eval_shape`` and zero-stride
    arrays onto the meta device, so nothing of the 1.1B–16.9B parameters
    is allocated."""
    shapes = jax.eval_shape(
        lambda: JaxModel(jax_get_config(arch)).init(jax.random.key(0)))
    tree = {p: np.broadcast_to(np.zeros((), s.dtype), s.shape)
            for p, s in zip(_leaf_paths(shapes), jax.tree.leaves(shapes))}
    params = params_from_numpy(get_config(arch), tree, "meta")
    got = leaf_paths(params)
    assert set(got) == set(tree)
    assert ("head/w" in got) == (not get_config(arch).tie_embeddings)
    assert ("adapter/w" in got) == (get_config(arch).frontend is not None)
    if arch == "seamless-m4t-medium":
        assert "encdec/decoder/cross_attn/wq" in got
        assert not any(p.startswith("blocks/") for p in got)
    for path, t in got.items():
        assert tuple(t.shape) == tree[path].shape and t.is_meta, path
        assert str(t.dtype).removeprefix("torch.") == str(tree[path].dtype)

    cfg = get_config(arch)
    first = next(iter(tree))
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(cfg, {k: v for k, v in tree.items()
                                if k != first}, "meta")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_numpy(cfg, {**tree, "blocks/p1/extra": tree[first]},
                          "meta")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, {**tree, first: np.zeros((3, 3))}, "meta")


def test_port_imports_neither_jax_nor_the_reference():
    banned = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                        re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        assert not banned.search(f.read_text()), f
    code = ("import pkgutil, sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert not [n for n, m in sys.modules.items() if m is not None"
            " and n.split('.')[0] in ('jax', 'repro')]\n"
            "assert {'repro_torch.core.' + m for m in ('cost_model', "
            "'schedule', 'hetero', 'auto', 'calibrate')} | {"
            "'repro_torch.runtime.profiler', 'repro_torch.runtime.straggler'}"
            " <= set(sys.modules)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "1", "--batch", "1", "--seq", "8",
                      "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 1
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_config(ARCH, smoke=True))
    assert Model(get_config(ARCH, smoke=True), "cpu").device.type == "cpu"
