"""Flash attention: blocked online-softmax GQA attention and its backward.

Replaces ``repro/kernels/flash_attention/flash.py``'s three TPU kernels:
``_flash_fwd_kernel`` (CUDA: ``csrc/flash_fwd.cu``), ``_flash_bwd_dq_kernel``
and ``_flash_bwd_dkv_kernel`` (CUDA: ``csrc/flash_bwd.cu``).
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain` are
their plain PyTorch versions (the full score matrix in f32), which the
wrappers run for CPU tensors and the tests and ``chip_smoke.py`` hold the
kernels against.  The differentiable op is :func:`.ops.flash`.

Causal masking is top-left aligned (query i sees keys 0..i), as in the
reference kernel and ``repro.kernels.flash_attention.ref.attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, plain

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 128, 256)      # head dims the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True):
    """q: (B, Sq, H, D), k/v: (B, Sk, K, D), H = K·G →
    (o (B, Sq, H, D) in q's dtype, lse (B, Sq, K, G) f32)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, Sq, K, G, D) * (D ** -0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0].permute(0, 3, 1, 2)       # (B, Sq, K, G)
    return o.reshape(B, Sq, H, D).to(q.dtype), lse.contiguous()


def flash_attention_bwd_plain(q, k, v, do, lse, delta, causal: bool = True):
    """The backward's explicit formulas over the full (Sq, Sk) matrix in
    f32, from the forward's ``lse`` and δ = rowsum(do∘o), both
    (B, Sq, K, G) → (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5
    qf = q.float().reshape(B, Sq, K, G, D)
    dof = do.float().reshape(B, Sq, K, G, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.permute(0, 2, 3, 1)[..., None])   # masked → 0
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_BWD_IN = [ctypes.c_void_p] * 6                 # q, k, v, do, lse, delta
_BWD_SHAPE = [ctypes.c_int] * 8                 # B Sq Sk H K D causal bf16


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True):
    """q: (B, Sq, H, D), k/v: (B, Sk, K, D) → (o (B, Sq, H, D) in q's
    dtype, lse (B, Sq, K, G) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or f32, contiguous, head dim in :data:`HEAD_DIMS`) or raise.  The
    dtype picks the kernel: bf16 the tensor-core one, f32 the FMA one.
    """
    if plain(q):
        return flash_attention_plain(q, k, v, causal)
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, Sq, K, H // K), dtype=torch.float32,
                      device=q.device)
    fn = build.function("repro_flash_fwd", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, Sq, Sk, H, K, D, int(causal),
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


def _bwd_call(name: str, outs: list, q, k, v, do, lse, delta, causal):
    B, Sq, H, D = q.shape
    fn = build.function(name, _BWD_IN + [ctypes.c_void_p] * len(outs)
                        + _BWD_SHAPE + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), B, Sq, k.shape[1], H,
                 k.shape[2], D, int(causal), int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dq (like q) of the backward; the dq CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if plain(q):
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, causal)[0]
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _bwd_call("repro_flash_bwd_dq", [dq], q, k, v, do, lse, delta, causal)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dk, dv) (like k, v) of the backward; the dk/dv CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if plain(q):
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, causal)[1:]
    _check_bwd(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_call("repro_flash_bwd_dkv", [dk, dv], q, k, v, do, lse, delta,
              causal)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, do, lse, delta, causal: bool = True):
    """q/do: (B, Sq, H, D), k/v: (B, Sk, K, D), lse/delta: (B, Sq, K, G)
    f32 → (dq, dk, dv).  CPU tensors take the plain version; CUDA tensors
    launch the dq and the dk/dv kernels (bf16 or f32, contiguous, head dim
    in :data:`HEAD_DIMS`) or raise."""
    if plain(q):
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, causal)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def _check(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got "
                         f"{q.device}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"dtypes must match and be one of {DTYPES}, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,H,D) and k/v (B,Sk,K,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("do must be contiguous and 16-byte aligned")
    B, Sq, H, _ = q.shape
    want = (B, Sq, k.shape[2], H // k.shape[2])
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be f32 {want} contiguous on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
