"""The port's ssm family (mamba2) against the reference, on the CPU.

The SSD scan's plain version against the reference's sequential oracle
and its Pallas kernel (interpret mode), the mixer against the
reference's ``ssd_block`` (``impl`` "ref" and "pallas"), then the model
on the ``shrink``-ed mamba2-1.3b (2 layers, 8 SSD heads of 32, state
16, chunk 32) with the weights bridged by ``params_from_numpy``: prefill
logits at a ragged ``last_idx``, the prefill's decode state against the
reference's ``serve_step`` run over the prompt token by token from a zero
state (the reference's own exact route: its ``prefill`` returns no SSD
state), decode, the Server's greedy tokens and the driver.  Training, as
the reference trains (through the differentiable chunked scan): the loss
and every gradient leaf under remat none and full, with and without a
``loss_mask``, both loss heads; the tied head's gradient in the table's;
three AdamW steps; and the training driver against the reference's loop.

Tolerances: the scan 5e-4 (the reference's SSD kernel test), logits 1e-4
(f32), the state against token-by-token decode 2e-3 (the reference's
decode-against-scan test); training f32 2e-5 for values and 2e-4 for
gradients (tests/torch_harness.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.ckpt.checkpoint import _leaf_paths
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.kernels.ssd.ref import ssd_ref
from repro.kernels.ssd.ssd import ssd_scan_pallas
from repro.models import mamba2 as jax_mamba2
from repro.models import transformer as jax_tfm
from repro.models.lm import Model as JaxModel
from repro.optim import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.kernels.ssd import ssd
from repro_torch.launch import serve, train
from repro_torch.models import mamba2
from repro_torch.models.convert import leaf_paths, params_from_numpy
from repro_torch.models.lm import Model
from repro_torch.optim import optimizer as torch_opt
from repro_torch.serving.server import Request, Server, prompt_bucket
from repro_torch.tree import flatten

from torch_harness import TOLS, close

ARCH = "mamba2-1.3b"
SCAN_TOL = 5e-4
TOL = 1e-4
STATE_TOL = 2e-3
TOLS_F32 = TOLS["float32"]


def _np_tree(tree) -> dict:
    return dict(zip(_leaf_paths(tree), map(np.asarray, jax.tree.leaves(tree))))


def _ssd_inputs(B, S, H, P, G, N, seed=0):
    """x, dt (post-softplus), A < 0, B, C as the reference's SSD test
    draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((B, S, G, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# the scan: plain version vs the reference's oracle and Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,G,N,C", [
    (1, 128, 2, 32, 1, 16, 64),
    (2, 256, 4, 16, 2, 32, 128),      # grouped B/C
    (1, 64, 2, 64, 1, 64, 64),        # single chunk
])
def test_ssd_plain_matches_reference_oracle_and_kernel(B, S, H, P, G, N, C):
    args = _ssd_inputs(B, S, H, P, G, N)
    y, h = ssd.ssd_scan_plain(*map(torch.tensor, args), chunk=C)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    y_ref, h_ref = ssd_ref(*map(jnp.asarray, args))
    y_pl, h_pl = ssd_scan_pallas(*map(jnp.asarray, args), chunk=C,
                                 interpret=True)
    for want_y, want_h in ((y_ref, h_ref), (y_pl, h_pl)):
        close(y, want_y, SCAN_TOL)
        close(h, want_h, SCAN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_takes_bf16_inputs_as_the_kernel_does(dtype):
    """x and B/C in bf16, dt and A in f32: the scan runs in f32 on the
    rounded inputs, as the Pallas kernel does."""
    args = _ssd_inputs(2, 64, 4, 32, 2, 16, seed=3)
    tdt = getattr(torch, dtype)
    x, dt, A, Bm, Cm = map(torch.tensor, args)
    x, Bm, Cm = (t.to(tdt) for t in (x, Bm, Cm))
    y, h = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    jx, jB, jC = (jnp.asarray(t.float().numpy()) for t in (x, Bm, Cm))
    y_pl, h_pl = ssd_scan_pallas(jx.astype(dtype), jnp.asarray(args[1]),
                                 jnp.asarray(args[2]), jB.astype(dtype),
                                 jC.astype(dtype), chunk=32, interpret=True)
    close(y, y_pl, SCAN_TOL)
    close(h, h_pl, SCAN_TOL)


def _split_bf16(a: torch.Tensor):
    """a = hi + lo + O(2⁻¹⁷|a|): hi = bf16(a), lo = bf16(a − hi) in f32."""
    hi = a.bfloat16().float()
    return hi, (a - hi).bfloat16().float()


def _ssd_tensor_core_rounding(x, dt, A, Bm, Cm, chunk):
    """The bf16 SSD kernel's rounding points in plain torch: bf16 x, B and
    C; S = C·Bᵀ in f32 (bf16 products are exact); S∘L masked before the
    exponential; every f32 operand — S∘L, xs = dt·x, h and xs·w with
    w = exp(cum_Q − cum_j) — split into bf16 hi and lo, the products
    summed in f32 with the lo·lo term dropped: (S∘L)·xs = hi·xh + hi·xl +
    lo·xh, C·h = C·hh + C·hl, (xs∘w)ᵀ·B = xwhᵀ·B + xwlᵀ·B."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = ssd.chunk_len(S, chunk)
    grp = torch.arange(H) // (H // G)
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    h = torch.zeros((Bsz, H, P, N))
    ys = []
    for q0 in range(0, S, Q):
        d = dt[:, q0:q0 + Q].float()                                 # (B,Q,H)
        cum = torch.cumsum(d * A.float(), dim=1).transpose(1, 2)     # (B,H,Q)
        xs = x[:, q0:q0 + Q].float() * d[..., None]                  # (B,Q,H,P)
        Bc = Bm[:, q0:q0 + Q].float()[:, :, grp]                     # (B,Q,H,N)
        Cc = Cm[:, q0:q0 + Q].float()[:, :, grp]
        seg = torch.where(tril, cum[..., :, None] - cum[..., None, :],
                          float("-inf"))
        sl_hi, sl_lo = _split_bf16(
            torch.einsum("bihn,bjhn->bhij", Cc, Bc) * torch.exp(seg))
        xh, xl = _split_bf16(xs)
        intra = sum(torch.einsum("bhij,bjhp->bihp", a, b)
                    for a, b in ((sl_hi, xh), (sl_hi, xl), (sl_lo, xh)))
        hh, hl = _split_bf16(h)
        carried = (torch.einsum("bihn,bhpn->bihp", Cc, hh)
                   + torch.einsum("bihn,bhpn->bihp", Cc, hl))
        ys.append(carried * torch.exp(cum).transpose(1, 2)[..., None]
                  + intra)
        total = cum[..., -1]                                         # (B,H)
        w = torch.exp(total[..., None] - cum).transpose(1, 2)        # (B,Q,H)
        xwh, xwl = _split_bf16(xs * w[..., None])
        h = (torch.exp(total)[..., None, None] * h
             + torch.einsum("bjhp,bjhn->bhpn", xwh, Bc)
             + torch.einsum("bjhp,bjhn->bhpn", xwl, Bc))
    return torch.cat(ys, dim=1), h


@pytest.mark.parametrize("B,S,H,P,G,N,C", [
    (1, 256, 2, 32, 1, 64, 64),       # G=1, the state carried over 4 chunks
    (2, 128, 4, 32, 2, 16, 32),       # G=2, 4 chunks
    (1, 64, 2, 32, 1, 32, 8),         # chunks of 8: shorter than a 16-row tile
    (1, 120, 2, 32, 2, 16, 40),       # a ragged chunk: 40 rows, 3 chunks
])
def test_ssd_tensor_core_rounding_matches_reference(B, S, H, P, G, N, C):
    """The bf16 kernel's precision design (bf16 hi/lo splits of its f32
    operands) against the reference's Pallas kernel on the same bf16
    inputs (interpret mode), within its 5e-4 on y and the state."""
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, G, N, seed=S + C)
    bf = lambda a: torch.tensor(a).bfloat16()
    y, h = _ssd_tensor_core_rounding(bf(x), torch.tensor(dt),
                                     torch.tensor(A), bf(Bm), bf(Cm), C)
    jbf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    y_pl, h_pl = ssd_scan_pallas(jbf(x), jnp.asarray(dt), jnp.asarray(A),
                                 jbf(Bm), jbf(Cm), chunk=C, interpret=True)
    close(y, y_pl, SCAN_TOL)
    close(h, h_pl, SCAN_TOL)


def test_ssd_wrapper_takes_the_plain_version_on_cpu_and_counts_nothing():
    args = [torch.tensor(a) for a in _ssd_inputs(1, 64, 2, 32, 1, 16)]
    n0 = ssd.ssd_scan.launches
    got = ssd.ssd_scan(*args, chunk=32)
    want = ssd.ssd_scan_plain(*args, chunk=32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ssd.ssd_scan.launches == n0


def test_ssd_wrapper_raises_off_the_cpu_and_on_a_ragged_chunk():
    """Off the CPU the wrapper launches its kernel or raises — it never
    falls back — and ``S % chunk != 0`` raises, as ``ssd_scan_pallas``
    does."""
    meta = [torch.empty(s, device="meta") for s in
            ((1, 64, 2, 32), (1, 64, 2), (2,), (1, 64, 1, 16), (1, 64, 1, 16))]
    with pytest.raises(ValueError):
        ssd.ssd_scan(*meta, chunk=32)
    args = [torch.tensor(a) for a in _ssd_inputs(1, 48, 2, 32, 1, 16)]
    with pytest.raises(ValueError, match="must divide"):
        ssd.ssd_scan(*args, chunk=32)
    assert ssd.chunk_len(16, 256) == 16


def test_ssd_scan_chunked_form_matches_reference_values_and_grads():
    """``models.mamba2.ssd_scan`` (the differentiable chunked form) against
    the reference's: values, and the VJP with the same cotangents."""
    args = _ssd_inputs(2, 96, 4, 16, 2, 32, seed=5)
    rng = np.random.default_rng(6)
    gy = rng.standard_normal((2, 96, 4, 16)).astype(np.float32)
    gh = rng.standard_normal((2, 4, 16, 32)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda x, dt, Bm, Cm: jax_mamba2.ssd_scan(x, dt, jnp.asarray(args[2]),
                                                  Bm, Cm, chunk=32),
        *(jnp.asarray(args[i]) for i in (0, 1, 3, 4)))
    want_g = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    ins = [torch.tensor(args[i], requires_grad=True) for i in (0, 1, 3, 4)]
    y, h = mamba2.ssd_scan(ins[0], ins[1], torch.tensor(args[2]), ins[2],
                           ins[3], chunk=32)
    close(y.detach(), want[0], 2e-5)
    close(h.detach(), want[1], 2e-5)
    got_g = torch.autograd.grad((y, h), ins, (torch.tensor(gy),
                                              torch.tensor(gh)))
    for g, w in zip(got_g, want_g):
        close(g, w, 2e-4)
    # and the chunked form agrees with the kernel's plain version
    yp, hp = ssd.ssd_scan_plain(*map(torch.tensor, args), chunk=32)
    close(y.detach(), yp, SCAN_TOL)
    close(h.detach(), hp, SCAN_TOL)


# ---------------------------------------------------------------------------
# the mixer vs the reference's ssd_block
# ---------------------------------------------------------------------------

BLOCK_CFGS = {
    "smoke": dict(d_model=128, n_heads=8, headdim=32, d_state=16, chunk=32),
    "groups2": dict(d_model=64, n_heads=4, headdim=32, d_state=32, chunk=16,
                    ngroups=2),
}


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("which", sorted(BLOCK_CFGS))
def test_ssd_block_matches_reference(which, impl):
    kw = BLOCK_CFGS[which]
    jcfg = jax_mamba2.SSDCfg(**kw)
    tcfg = mamba2.SSDCfg(**kw)
    jp = jax_mamba2.init_ssd(jax.random.key(1), jcfg, jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal(
        (2, 64, kw["d_model"])).astype(np.float32) * 0.5
    want = jax_mamba2.ssd_block(jp, jnp.asarray(x), jcfg, impl=impl)
    got = mamba2.ssd_block(tp, torch.tensor(x), tcfg)
    close(got, want, TOL)


def test_ssd_block_state_matches_reference_decode_steps():
    """The mixer's state after ``last_idx`` (dt zeroed past it) against
    the reference's ``ssd_decode_step`` run token by token from zero, for
    two rows of different lengths; the outputs at real positions do not
    change."""
    kw = BLOCK_CFGS["groups2"]
    jcfg, tcfg = jax_mamba2.SSDCfg(**kw), mamba2.SSDCfg(**kw)
    jp = jax_mamba2.init_ssd(jax.random.key(3), jcfg, jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 48, 64)).astype(
        np.float32) * 0.5
    last = [20, 1]
    out, st = mamba2.ssd_block(tp, torch.tensor(x), tcfg,
                               last_idx=torch.tensor(last), return_state=True)
    full = mamba2.ssd_block(tp, torch.tensor(x), tcfg)
    for b, n in enumerate(last):
        close(out[b, :n + 1], full[b, :n + 1], TOL)
        state = jax_mamba2.init_ssd_state(1, jcfg, jnp.float32)
        for t in range(n + 1):
            _, state = jax_mamba2.ssd_decode_step(jp, jnp.asarray(x[b:b + 1, t]),
                                                  state, jcfg)
        close(st["h"][b], state["h"][0], STATE_TOL)
        close(st["conv"][b], state["conv"][0], STATE_TOL)


# ---------------------------------------------------------------------------
# the model on the shrink-ed mamba2-1.3b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) on one weight set."""
    jm = JaxModel(jax_get_config(ARCH, smoke=True))
    jp = jm.init(jax.random.key(0))
    tm = Model(get_config(ARCH, smoke=True), device="cpu")
    return jm, jp, tm, params_from_numpy(tm.cfg, _np_tree(jp), "cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _reference_state(jm, jp, prompt):
    """The reference's exact route to a prompt's decode state: its
    ``serve_step`` over the prompt token by token from a zero state (at
    batch 1).  Returns (the last step's logits, the state)."""
    state = {"cache": jax_tfm.init_stack_state(jm.stack, 1, 8, jm.cfg.adtype),
             "pos": jnp.zeros((1,), jnp.int32)}
    step = jax.jit(jm.serve_step)
    for tok in prompt:
        logits, state = step(jp, jnp.asarray([tok], jnp.int32), state)
    return logits, state


def test_config_matches_reference():
    """Every field the port keeps has the reference's value, full and
    smoke; 64 SSD heads of 64 at full width."""
    for smoke in (False, True):
        ours = get_config(ARCH, smoke=smoke)
        ref = jax_get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
        assert ours.padded_vocab == ref.padded_vocab
        for f in dataclasses.fields(mamba2.SSDCfg):
            assert getattr(ours.ssd_cfg(), f.name) == getattr(
                ref.ssd_cfg(), f.name), f.name
    full = get_config(ARCH).ssd_cfg()
    assert (full.n_heads, full.headdim, full.d_state, full.d_inner) == (
        64, 64, 128, 4096)


def test_init_matches_reference_in_distribution():
    """Same leaves, shapes and dtypes as the reference's ``Model.init``
    (no ``head``: tied embeddings); the deterministic leaves equal, the
    random ones alike in mean and std."""
    cfg = get_config(ARCH, smoke=True)
    ours = leaf_paths(Model(cfg, device="cpu").init(0))
    ref = _np_tree(JaxModel(jax_get_config(ARCH, smoke=True)).init(
        jax.random.key(0)))
    assert set(ours) == set(ref) and not any(p.startswith("head")
                                             for p in ours)
    for path, t in ours.items():
        r = ref[path]
        assert tuple(t.shape) == r.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), path
        a = t.numpy()
        if path.split("/")[-1] in ("A_log", "dt_bias", "D_skip",
                                   "norm_scale", "scale"):
            np.testing.assert_allclose(a, r, rtol=1e-6, err_msg=path)
        else:
            assert abs(a.mean() - r.mean()) < 0.05 * r.std() + 1e-6, path
            assert abs(a.std() / r.std() - 1) < 0.1, path


@pytest.mark.parametrize("S,last", [(64, [40, 63]), (16, [4, 15])])
def test_prefill_logits_match_reference(pair, S, last):
    """At a ragged ``last_idx``; S=64 runs two chunks of 32, S=16 one
    chunk of 16."""
    jm, jp, tm, tp = pair
    tokens = _tokens(tm.cfg, (2, S))
    want, jst = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, gen_budget=8,
                           last_idx=jnp.asarray(last))
    got, st = tm.prefill(tp, {"tokens": torch.tensor(tokens)}, gen_budget=8,
                         last_idx=torch.tensor(last))
    close(got, want, TOL)
    np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(jst["pos"]))
    # state leaves are not KV: never padded to S + gen_budget
    L, H, P, N = 2, 8, 32, 16
    assert st["cache"]["p0"]["h"].shape == (L, 2, H, P, N)
    assert st["cache"]["p0"]["conv"].shape == (L, 2, 3, H, P)


def test_prefill_state_matches_reference_token_by_token(pair):
    """Each layer's ``h`` and ``conv`` after a ragged batch-2 prefill
    against the reference's ``serve_step`` over each prompt from zero."""
    jm, jp, tm, tp = pair
    tokens = _tokens(tm.cfg, (2, 64), seed=1)
    last = [37, 63]
    logits, st = tm.prefill(tp, {"tokens": torch.tensor(tokens)},
                            last_idx=torch.tensor(last))
    for b, n in enumerate(last):
        jlogits, jst = _reference_state(jm, jp, tokens[b, :n + 1])
        close(logits[b], jlogits[0], STATE_TOL)
        for key in ("h", "conv"):
            close(st["cache"]["p0"][key][:, b],
                  jst["cache"]["p0"][key][:, 0], STATE_TOL)


def test_serve_step_matches_reference(pair):
    """Decode steps from one state (the reference's token-by-token state,
    copied to the port): logits and the updated state agree."""
    jm, jp, tm, tp = pair
    prompt = _tokens(tm.cfg, (11,), seed=2)
    _, jst = _reference_state(jm, jp, prompt)
    st = {"cache": {"p0": {k: torch.tensor(np.asarray(v)) for k, v in
                           jst["cache"]["p0"].items()}},
          "pos": torch.tensor(np.asarray(jst["pos"]))}
    for step in range(4):
        nxt = _tokens(tm.cfg, (1,), seed=10 + step)
        logits, st = tm.serve_step(tp, torch.tensor(nxt), st)
        jlogits, jst = jm.serve_step(jp, jnp.asarray(nxt, jnp.int32), jst)
        close(logits, jlogits, TOL)
    for key in ("h", "conv"):
        close(st["cache"]["p0"][key], jst["cache"]["p0"][key], TOL)
    np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(jst["pos"]))


MAX_LEN = 64
SPEC = [(6, 12), (9, 12), (40, 8), (5, 12)]       # (prompt length, max_new)


def test_server_tokens_match_reference_loop(pair):
    """A dense Server with 3 slots and mixed prompt lengths (buckets 8, 16
    and 64, the last two chunks of 32) gives each request the greedy
    tokens of a reference loop built from ``serve_step`` alone."""
    jm, jp, tm, tp = pair
    prompts = [_tokens(tm.cfg, (n,), seed=30 + i)
               for i, (n, _) in enumerate(SPEC)]
    step = jax.jit(jm.serve_step)
    want = []
    for prompt, (_, max_new) in zip(prompts, SPEC):
        logits, st = _reference_state(jm, jp, prompt)
        toks = [int(jnp.argmax(logits[0, :jm.cfg.vocab]))]
        while toks[-1] != 1 and len(toks) < max_new:
            logits, st = step(jp, jnp.asarray(toks[-1:], jnp.int32), st)
            toks.append(int(jnp.argmax(logits[0, :jm.cfg.vocab])))
        want.append(toks)

    server = Server(tm, batch_slots=3, max_len=MAX_LEN, cache="dense")
    pending = [Request(i, p.astype(np.int32), max_new=g)
               for i, (p, (_, g)) in enumerate(zip(prompts, SPEC))]
    done = {}
    for _ in range(200):
        if not (pending or server.active):
            break
        while pending and (slot := server.free_slot()) is not None:
            req = pending.pop(0)
            server.admit(tp, req, slot)
            if req.done:
                done[req.rid] = req
        done.update((r.rid, r) for r in server.step(tp))
    assert sorted(done) == list(range(len(SPEC)))
    for rid, toks in enumerate(want):
        assert done[rid].out_tokens == toks, f"request {rid} diverged"
    assert {prompt_bucket(n, MAX_LEN) for n, _ in SPEC} == {8, 16, 64}
    assert server.prefill_cache_size == 3


def test_paged_server_over_ssm_raises(pair):
    tm = pair[2]
    assert not tm.supports_paged
    with pytest.raises(ValueError, match="paged"):
        Server(tm, batch_slots=2, max_len=32, cache="paged", page_size=8)
    with pytest.raises(ValueError, match="paged"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--cache",
                    "paged"])


def test_serving_params_keep_the_f32_reads():
    """With bf16 activations, the cast-once serving params give logits
    equal bit for bit to the un-cast f32 params (every product casts its
    weight anyway), because ``wdt``, ``dt_bias``, ``A_log`` and
    ``norm_scale`` stay f32; casting those too changes the logits."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="bfloat16")
    tm = Model(cfg, device="cpu")
    params = tm.init(0)
    sp = tm.serving_params(params)
    kept = {"wdt", "dt_bias", "A_log", "norm_scale", "scale"}
    for path, t in leaf_paths(sp).items():
        want = torch.float32 if path.split("/")[-1] in kept else torch.bfloat16
        assert t.dtype == want, path
    tokens = torch.tensor(_tokens(cfg, (1, 24), seed=4))
    last = torch.tensor([20])

    def run(p):
        logits, st = tm.prefill(p, {"tokens": tokens}, last_idx=last)
        out = [logits]
        for t in range(3):
            logits, st = tm.serve_step(p, tokens[:, t], st)
            out.append(logits)
        return torch.stack(out)

    base = run(params)
    assert torch.equal(run(sp), base)
    naive = params_from_numpy(cfg, {k: v.to(torch.bfloat16).float().numpy()
                                    for k, v in leaf_paths(params).items()},
                              "cpu")
    assert not torch.equal(run(naive), base)


def test_serve_driver_completes_every_request():
    s = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--cache",
                    "dense", "--requests", "6", "--batch-slots", "3",
                    "--prompt-len", "40", "--gen", "5", "--max-len", "64"])
    assert s["completed"] == 6
    assert s["tokens"] >= 6 and s["steps"] > 0


# ---------------------------------------------------------------------------
# training: the loss, every gradient, AdamW and the driver
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 64        # two chunks of 32 a row
LR = 1e-3
STEPS = 3


def _train_cfgs(remat: str):
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True),
                                remat=remat),
            dataclasses.replace(get_config(ARCH, smoke=True), remat=remat))


@pytest.fixture(scope="module")
def trained():
    """The reference's unmeshed loss and gradients of the smoke model, with
    and without a ``loss_mask``, and three AdamW steps; its table's
    gradient with the head's part cut off (the lookup's alone)."""
    jcfg, _ = _train_cfgs("none")
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
    mask = (rng.random((TRAIN_B, TRAIN_S)) < 0.7).astype(np.float32)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    out = {"params": _np_tree(params), "tokens": tokens, "mask": mask}
    for masked in (False, True):
        batch = {"tokens": jnp.asarray(tokens)}
        if masked:
            batch["loss_mask"] = jnp.asarray(mask)
        (loss, m), g = grad_fn(params, batch)
        out[masked] = (float(loss), {k: float(v) for k, v in m.items()},
                       _np_tree(g))
    opt = jax_opt.adamw(lr=LR)
    p, st, losses = params, opt.init(params), []
    for i in range(STEPS):
        (loss, _), g = grad_fn(p, {"tokens": jnp.asarray(tokens)})
        p, st = opt.apply(g, st, p, i)
        losses.append(float(loss))
    out["losses"] = losses
    return out


@pytest.mark.parametrize("impl", ["chunked", "fused"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_gradient_match_reference(trained, remat, masked,
                                                 impl):
    """``Model.loss_fn`` through the differentiable scan: the loss, its
    metrics and every gradient leaf against the reference's at f32 2e-5 /
    2e-4, under both loss heads (the fused one's plain versions)."""
    _, cfg = _train_cfgs(remat)
    params = params_from_numpy(cfg, trained["params"], "cpu")
    for v in flatten(params)[1]:
        v.requires_grad_(True)
    batch = {"tokens": torch.tensor(trained["tokens"])}
    if masked:
        batch["loss_mask"] = torch.tensor(trained["mask"])
    loss, m = Model(cfg, "cpu", xent_impl=impl).loss_fn(params, batch)
    want_loss, want_m, want_g = trained[masked]
    np.testing.assert_allclose(loss.item(), want_loss, atol=TOLS_F32.fwd,
                               rtol=TOLS_F32.fwd)
    for k, v in want_m.items():
        np.testing.assert_allclose(m[k].item(), v, atol=TOLS_F32.fwd,
                                   rtol=TOLS_F32.fwd, err_msg=k)
    loss.backward()
    got = dict(zip(*flatten(params)))
    assert sorted(got) == sorted(want_g) and "head" not in params
    for path, w in want_g.items():
        np.testing.assert_allclose(got[path].grad.numpy(), w,
                                   atol=TOLS_F32.grad, rtol=TOLS_F32.grad,
                                   err_msg=path)


def test_training_runs_the_scan_and_serving_the_kernel(trained, monkeypatch):
    """The training forward reaches ``mamba2.ssd_scan`` (differentiable),
    never the forward-only kernel wrapper; prefill the kernel wrapper."""
    _, cfg = _train_cfgs("full")
    model = Model(cfg, "cpu")
    params = params_from_numpy(cfg, trained["params"], "cpu")
    for v in flatten(params)[1]:
        v.requires_grad_(True)
    calls = {"scan": 0, "kernel": 0}
    real_scan, real_kernel = mamba2.ssd_scan, mamba2.ssd_kernel

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(mamba2, "ssd_scan", count("scan", real_scan))
    monkeypatch.setattr(mamba2, "ssd_kernel", count("kernel", real_kernel))
    tokens = torch.tensor(trained["tokens"])
    model.loss_fn(params, {"tokens": tokens})[0].backward()
    assert calls == {"scan": 2 * cfg.n_layers, "kernel": 0}   # + recompute
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens})
    assert calls["kernel"] == cfg.n_layers


def test_tied_head_gradient_reaches_the_table(trained):
    """The table's gradient is the lookup's plus the tied head's: equal to
    the reference's, and far from the lookup's alone."""
    _, cfg = _train_cfgs("none")
    model = Model(cfg, "cpu")
    batch = {"tokens": torch.tensor(trained["tokens"])}
    want = trained[False][2]["embed/table"]

    def table_grad(cut_head: bool):
        params = params_from_numpy(cfg, trained["params"], "cpu")
        table = params["embed"]["table"].requires_grad_(True)
        if cut_head:
            model._head_w = lambda p: p["embed"]["table"].detach().T
        try:
            model.loss_fn(params, batch)[0].backward()
        finally:
            model.__dict__.pop("_head_w", None)
        return table.grad.numpy()

    np.testing.assert_allclose(table_grad(False), want, atol=TOLS_F32.grad,
                               rtol=TOLS_F32.grad)
    lookup = table_grad(True)
    assert np.abs(lookup - want).max() > 100 * TOLS_F32.grad
    # the lookup touches only the batch's rows; the head every row
    rows = np.unique(trained["tokens"])
    untouched = np.setdiff1d(np.arange(cfg.padded_vocab), rows)
    assert not lookup[untouched].any() and want[untouched].any()


def test_three_adamw_steps_match_reference(trained):
    _, cfg = _train_cfgs("full")
    model = Model(cfg, "cpu")
    params = params_from_numpy(cfg, trained["params"], "cpu")
    o = torch_opt.adamw(lr=LR)
    state = o.init(params)
    step = planner.compile_plan(model, None).train_step_fn(o)
    batch = {"tokens": torch.tensor(trained["tokens"])}
    losses = []
    for i in range(STEPS):
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, trained["losses"], atol=TOLS_F32.fwd,
                               rtol=TOLS_F32.fwd)


def test_train_driver_losses_match_reference_loop(tmp_path):
    """``train --arch mamba2-1.3b --smoke --device cpu`` from the
    reference's step 0 against the reference's loop of its unmeshed
    pieces (the driver's schedule and token stream)."""
    steps, batch, seq = 3, 2, 64
    jm = JaxModel(jax_get_config(ARCH, smoke=True))
    params = jm.init(jax.random.key(0))
    sched = jax_opt.Schedule(base_lr=3e-4, warmup=min(100, steps // 10 + 1),
                             decay_steps=steps)
    o = jax_opt.adamw(lr=sched)
    state = o.init(params)
    data = jax_pipeline.TokenPipeline(
        jax_pipeline.DataCfg(global_batch=batch, seq_len=seq,
                             vocab=jm.cfg.vocab, seed=0), host_id=0,
        n_hosts=1)
    JaxCheckpointManager(str(tmp_path)).save(
        0, {"params": params, "opt": state},
        extra={"data": data.state_dict()})
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    want = []
    for i in range(steps):
        (loss, _), g = grad_fn(params, {"tokens": jnp.asarray(
            data.next_batch()["tokens"])})
        params, state = o.apply(g, state, params, i)
        want.append(float(loss))
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", str(steps), "--batch", str(batch), "--seq",
                      str(seq), "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == steps
    np.testing.assert_allclose(out["losses"], want, atol=TOLS_F32.grad,
                               rtol=TOLS_F32.grad)

