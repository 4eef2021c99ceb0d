"""Paged flash-decode: one decode step of GQA attention reading KV pages
through a block table.

Replaces ``repro/kernels/flash_attention/paged.py::_paged_decode_kernel``.
The CUDA kernel is ``csrc/paged_decode.cu``; :func:`paged_decode_plain` is
its plain PyTorch version (gather every page of the table, mask, softmax).

The kernel splits each slot's live keys across a cluster of 8 blocks,
each owning a run of tiles and its own online-softmax state; the ranks'
states are merged in rank order through distributed shared memory, in the
one launch.  bf16 scores tiles of 64 keys on the tensor cores (16 keys a
warp, p rounded to bf16 before P·V, one state a warp); f32 scores tiles
of about 8 KB of K on the FMA pipes (one state a lane group of 16 or 32
lanes, a few keys a tile each).  Head dims 64, 80, 128 and 256; groups
of 1, 2, 4, 6 (grok-1's 48 q over 8 kv heads) and 8 query heads a kv head.

Page 0 is the all-zero trash page: unallocated block-table entries and
inactive slots (table row all 0, ``pos`` 0) point at it, so they read
zeros and produce a finite output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, plain

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 128, 256)
GROUPS = (1, 2, 4, 6, 8)            # query heads per kv head the kernel takes
DTYPES = (torch.float32, torch.bfloat16)


def paged_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_table: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k_pool/v_pool: (P, page_size, K, D); block_table:
    (B, max_pages) int32; pos: (B,) int32 → (B, H, D) in q's dtype.

    Keys at logical positions ``<= pos[b]`` are attended, so the new
    token's KV must already be in the pools.
    """
    B, H, D = q.shape
    _, ps, K, _ = k_pool.shape
    G = H // K
    mp = block_table.shape[1]
    bt = block_table.long()
    kg = k_pool[bt].reshape(B, mp * ps, K, D).float()
    vg = v_pool[bt].reshape(B, mp * ps, K, D).float()
    qf = q.float().reshape(B, K, G, D) * (D ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qf, kg)
    valid = (torch.arange(mp * ps, device=q.device)[None, :]
             <= pos.long()[:, None])                            # (B, mp·ps)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, vg) / l.clamp_min(1e-30)
    return out.reshape(B, H, D).to(q.dtype)


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """See :func:`paged_decode_plain`.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if plain(q):
        return paged_decode_plain(q, k_pool, v_pool, block_table, pos)
    _check(q, k_pool, v_pool, block_table, pos)
    B, H, D = q.shape
    P, ps, K, _ = k_pool.shape
    out = torch.empty_like(q)
    fn = build.function("repro_paged_decode", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 B, H, K, D, P, ps, block_table.shape[1],
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def _check(q, k_pool, v_pool, block_table, pos) -> None:
    tensors = (q, k_pool, v_pool, block_table, pos)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode wants every tensor on one cuda device "
                         "(or q on the cpu for the plain version)")
    if q.dtype not in DTYPES or not (k_pool.dtype == v_pool.dtype == q.dtype):
        raise ValueError(f"q and the pools must share a dtype in {DTYPES}")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("block_table and pos must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q (B,H,D) and pools (P,page,K,D), got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}")
    B, H, D = q.shape
    K = k_pool.shape[2]
    if k_pool.shape[3] != D or H % K or H // K not in GROUPS:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not fit q "
                         f"{tuple(q.shape)} (group must be in {GROUPS})")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or pos.shape != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / pos "
                         f"{tuple(pos.shape)} do not fit batch {B}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("paged_decode inputs must be contiguous and "
                             "16-byte aligned")
