"""The port's attention kernels: plain versions against the reference's
Pallas kernels (interpret mode, as tests/test_kernels.py runs them) and
oracles on the CPU.  The CUDA kernels against their plain versions on the
card: tests/test_torch_gpu.py.

Tolerances follow the reference's policy (tests/kernel_harness.py): f32
2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash import flash_attention as jax_flash
from repro.kernels.flash_attention.paged import paged_decode as jax_paged
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import paged_scatter as jax_paged_scatter
from repro_torch.kernels.flash_attention import flash, paged
from repro_torch.models.attention import paged_scatter

from torch_harness import TOL, close, np_inputs, paged_inputs


# ---------------------------------------------------------------------------
# flash forward: plain version vs the reference kernel and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal", [
    (1, 128, 128, 4, 4, 32, True),      # MHA
    (2, 128, 128, 4, 2, 32, True),      # GQA group 2
    (1, 128, 128, 8, 1, 16, True),      # MQA
    (1, 64, 128, 4, 2, 32, False),      # cross shape: Sq != Sk, no mask
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference(B, Sq, Sk, H, K, D, causal, dtype):
    q, k, v = np_inputs((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want_o, want_lse = jax_flash(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64, interpret=True, return_lse=True)
    tq, tk, tv = (torch.tensor(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    o, lse = flash.flash_attention(tq, tk, tv, causal)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert lse.shape == (B, Sq, K, H // K)
    close(o.float(), want_o, TOL[dtype])
    close(lse, want_lse, TOL[dtype])
    close(o.float(), attention_ref(jq, jk, jv, causal=causal), TOL[dtype])


def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    q, k, v = np_inputs((1, 16, 4, 8), (1, 16, 2, 8), (1, 16, 2, 8))
    n0 = flash.flash_attention.launches
    o, lse = flash.flash_attention(*map(torch.tensor, (q, k, v)))
    o2, lse2 = flash.flash_attention_plain(*map(torch.tensor, (q, k, v)))
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert flash.flash_attention.launches == n0

    qd, kp, vp = np_inputs((2, 4, 8), (3, 4, 2, 8), (3, 4, 2, 8))
    bt = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    pos = torch.tensor([5, 0], dtype=torch.int32)
    n0 = paged.paged_decode.launches
    out = paged.paged_decode(torch.tensor(qd), torch.tensor(kp),
                             torch.tensor(vp), bt, pos)
    assert torch.equal(out, paged.paged_decode_plain(
        torch.tensor(qd), torch.tensor(kp), torch.tensor(vp), bt, pos))
    assert paged.paged_decode.launches == n0


def test_wrappers_reject_other_devices():
    """Off the CPU a wrapper launches its kernel or raises — it never
    falls back to the plain version."""
    q = torch.empty((1, 16, 4, 64), device="meta")
    k = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(ValueError):
        flash.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        paged.paged_decode(torch.empty((2, 4, 64), device="meta"),
                           torch.empty((3, 4, 2, 64), device="meta"),
                           torch.empty((3, 4, 2, 64), device="meta"),
                           torch.empty((2, 2), dtype=torch.int32,
                                       device="meta"),
                           torch.empty((2,), dtype=torch.int32,
                                       device="meta"))


# ---------------------------------------------------------------------------
# paged decode: plain version vs the reference kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,K,D,ps,mp", [
    (3, 4, 2, 16, 4, 3),       # GQA group 2
    (4, 8, 1, 32, 8, 4),       # MQA
    (2, 4, 4, 16, 4, 5),       # MHA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_reference(B, H, K, D, ps, mp, dtype):
    P = 1 + B * mp
    q, kp, vp, table, pos = paged_inputs(B, H, K, D, ps, mp, P)
    want = jax_paged(*(jnp.asarray(a, dtype) for a in (q, kp, vp)),
                     jnp.asarray(table), jnp.asarray(pos), interpret=True)
    tdt = getattr(torch, dtype)
    got = paged.paged_decode(*(torch.tensor(a).to(tdt) for a in (q, kp, vp)),
                             torch.tensor(table), torch.tensor(pos))
    assert got.dtype == tdt and got.shape == (B, H, D)
    assert torch.isfinite(got[-1]).all()               # inactive slot
    close(got.float(), want, TOL[dtype])


def _online(state, s, v, p_dtype=torch.float32):
    """One online-softmax update of (m, l, acc) over keys s (..., n) with
    values v (n, ..., D), in f32; p is rounded to ``p_dtype`` before P·V,
    and l sums the f32 p."""
    m, l, acc = state
    if s.shape[-1] == 0:
        return state
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    pv = torch.einsum("kgn,nkd->kgd", p.to(p_dtype).float(), v)
    return m_new, l * corr + p.sum(-1), acc * corr[..., None] + pv


def _merge(states):
    """Online-softmax states merged in order (the kernel's lane groups of
    a block, then the ranks of a cluster)."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    l, acc = 0.0, 0.0
    for m, li, ai in states:
        w = torch.exp(m - mx)
        l, acc = l + li * w, acc + ai * w[..., None]
    return mx, l, acc


# The cluster kernel's partition, as csrc/paged_decode.cu fixes it: SPLIT
# blocks per cluster, MK keys per bf16 tile, TILE_BYTES of K per f32 tile.
PAGED_SPLIT, PAGED_BF16_TILE_KEYS, PAGED_F32_TILE_BYTES = 8, 64, 8192


def _paged_cluster_split(q, k_pool, v_pool, table, pos):
    """The cluster kernel's partition and merges in plain torch: each
    slot's live keys 0..pos cut into tiles, rank r of PAGED_SPLIT taking
    a run of ceil(tiles / PAGED_SPLIT) of them; each partial state folds
    its keys of every tile in one online update.  bf16 (the tensor-core
    kernel): tiles of 64 keys, warp w's state takes keys 16w..16w+15, p
    rounded to bf16 before P·V (l sums the f32 p).  f32 (the FMA kernel):
    tiles of PAGED_F32_TILE_BYTES / (4·D) keys, lane group `slot` of
    128 / (D/4) takes keys u·NSLOT + slot (u < 4).  A block merges its
    states, the cluster its ranks, in order; out = acc / max(l, 1e-30),
    rounded once to q's dtype."""
    B, H, D = q.shape
    P, ps, K, _ = k_pool.shape
    G = H // K
    if q.dtype == torch.bfloat16:
        tk, nstate, rnd = PAGED_BF16_TILE_KEYS, 4, torch.bfloat16
        owned = lambda st, t0: range(t0 + 16 * st, t0 + 16 * st + 16)
    else:
        tk, rnd = PAGED_F32_TILE_BYTES // (4 * D), torch.float32
        nstate = 128 // (D // 4)
        owned = lambda st, t0: (t0 + u * nstate + st for u in range(4))
    out = torch.empty((B, H, D))
    empty = (torch.full((K, G), paged.NEG_INF), torch.zeros((K, G)),
             torch.zeros((K, G, D)))
    for b in range(B):
        n = min(max(int(pos[b]) + 1, 0), table.shape[1] * ps)
        keys = torch.arange(n)
        phys = table[b, keys // ps].long()
        phys = torch.where((phys >= 0) & (phys < P), phys, 0)
        kk = k_pool[phys, keys % ps].float()                    # (n, K, D)
        vv = v_pool[phys, keys % ps].float()
        qs = q[b].float().reshape(K, G, D)
        s_all = torch.einsum("kgd,nkd->kgn", qs, kk) * D ** -0.5
        per = -(-(-(-n // tk)) // PAGED_SPLIT)
        ranks = []
        for r in range(PAGED_SPLIT):
            lo = min(r * per * tk, n)
            hi = min(lo + per * tk, n)
            states = []
            for st_i in range(nstate):
                st = empty
                for t0 in range(lo, hi, tk):
                    idx = [k for k in owned(st_i, t0) if k < hi]
                    st = _online(st, s_all[..., idx], vv[idx], rnd)
                states.append(st)
            ranks.append(_merge(states))
        _, l, acc = _merge(ranks)
        out[b] = (acc / l.clamp_min(1e-30)[..., None]).reshape(H, D)
    return out.to(q.dtype)


@pytest.mark.parametrize("B,H,K,D,ps,mp", [
    (3, 8, 2, 64, 16, 12),     # ≤ 192 keys: fewer tiles than the 8 ranks
    (4, 16, 2, 64, 16, 40),    # up to 640 keys: more tiles than ranks
    (2, 4, 4, 128, 16, 8),     # D=128, MHA; one live slot
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_cluster_split_matches_reference(B, H, K, D, ps, mp, dtype):
    """The cluster kernel's page split and rank-order merge against the
    reference's kernel (interpret mode), at the f32/bf16 tolerances; the
    last slot is inactive (table row 0, pos 0) and stays finite."""
    P = 1 + B * mp
    q, kp, vp, table, pos = paged_inputs(B, H, K, D, ps, mp, P, seed=D + mp)
    want = jax_paged(*(jnp.asarray(a, dtype) for a in (q, kp, vp)),
                     jnp.asarray(table), jnp.asarray(pos), interpret=True)
    tdt = getattr(torch, dtype)
    got = _paged_cluster_split(*(torch.tensor(a).to(tdt) for a in (q, kp, vp)),
                               torch.tensor(table), torch.tensor(pos))
    assert got.dtype == tdt and torch.isfinite(got[-1]).all()
    close(got.float(), want, TOL[dtype])


def test_paged_scatter_matches_reference_and_drops_trash_writes():
    B, K, D, ps, mp, P = 4, 2, 8, 4, 3, 9
    (pool, new) = np_inputs((P, ps, K, D), (B, K, D), seed=5)
    pool[0] = 0
    table = np.array([[3, 5, 0], [0, 0, 0], [7, 0, 0], [2, 4, 6]], np.int32)
    pos = np.array([5, 0, 2, 9], np.int32)             # slot 1 inactive
    # the cells written are zero before the write, by the allocator invariant
    for b in (0, 2, 3):
        pool[table[b, pos[b] // ps], pos[b] % ps] = 0
    want = jax_paged_scatter(jnp.asarray(pool), jnp.asarray(table),
                             jnp.asarray(pos), jnp.asarray(new))
    t = torch.tensor(pool)
    out = paged_scatter(t, torch.tensor(table), torch.tensor(pos),
                        torch.tensor(new))
    assert out is t                                     # written in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert not out[0].any()
    np.testing.assert_array_equal(out[5, 1], new[0])
    # a position past the table is dropped too, not written into it
    before = t.clone()
    only_slot0 = torch.tensor(table)
    only_slot0[1:] = 0
    paged_scatter(t, only_slot0, torch.tensor([12, 0, 0, 0],
                                              dtype=torch.int32),
                  torch.tensor(new))
    assert torch.equal(t, before)
