"""Flash attention forward: blocked online-softmax GQA attention.

Replaces ``repro/kernels/flash_attention/flash.py::_flash_fwd_kernel``.
The CUDA kernel is ``csrc/flash_fwd.cu``; :func:`flash_attention_plain` is
its plain PyTorch version (the full score matrix in f32), which the
wrapper runs for CPU tensors and the tests and ``chip_smoke.py`` hold the
kernel against.

Causal masking is top-left aligned (query i sees keys 0..i), as in the
reference kernel and ``repro.kernels.flash_attention.ref.attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)               # head dims the kernel is built for
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


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True):
    """q: (B, Sq, H, D), k/v: (B, Sk, K, D) → (o (B, Sq, H, D) in q's
    dtype, lse (B, Sq, K, G) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or f32, contiguous, head dim in :data:`HEAD_DIMS`) or raise.
    """
    if q.device.type == "cpu":
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
