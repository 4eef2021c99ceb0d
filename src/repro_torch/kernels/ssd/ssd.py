"""The Mamba2 SSD (state-space duality) chunked scan, forward only.

Replaces ``repro/kernels/ssd/ssd.py::_ssd_kernel`` (CUDA:
``csrc/ssd_scan.cu``).  Per chunk of Q positions, with
``cum = cumsum(dt·A)`` over the chunk:

- the intra-chunk term ``(C·Bᵀ ∘ L)·(dt·x)``,
  ``L[i, j] = exp(cum_i − cum_j)·[i ≥ j]``;
- the carried-state term ``(C·h)·exp(cum)``, from the state *before*
  this chunk;
- the state update ``h' = exp(cum_Q)·h + Σ_q exp(cum_Q − cum_q)·dt_q·x_q ⊗
  B_q``.

For bf16 inputs the kernel runs the three products on the tensor cores
(bf16 operands, f32 sums): C and B enter as they are, and every f32
operand (``S∘L``, ``dt·x``, ``h``, the decayed ``dt·x``) is split into
``hi = bf16(a)`` and ``lo = bf16(a − hi)``, the lo·lo term dropped, for a
relative error near 2⁻¹⁷.  f32 inputs take its FMA kernel.

:func:`ssd_scan_plain` repeats that arithmetic in f32 with PyTorch; the
wrapper :func:`ssd_scan` runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it.  Training differentiates
:func:`repro_torch.models.mamba2.ssd_scan` instead, as the reference does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, plain

DTYPES = (torch.float32, torch.bfloat16)
COLS = 32                    # head-dim columns per block of the kernel
MAX_CHUNK = 256              # longest chunk the kernel takes
STATES = (16, 32, 64, 128)   # d_state values the kernel is built for


def chunk_len(S: int, chunk: int) -> int:
    """``min(chunk, S)``, which must divide ``S`` (as
    ``ssd_scan_pallas`` requires)."""
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"S={S} must divide chunk={Q}")
    return Q


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int):
    """x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, G, N) →
    (y (B, S, H, P) f32, final state (B, H, P, N) f32), chunk by chunk in
    f32 with the state carried, as the kernel computes it.  Group ``g``
    serves heads ``g·H/G … (g+1)·H/G − 1``."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk_len(S, chunk)
    dev = x.device
    grp = torch.arange(H, device=dev) // (H // G)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    A = A.float()
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
    ys = []
    for q0 in range(0, S, Q):
        xd = x[:, q0:q0 + Q].float() * dt[:, q0:q0 + Q, :, None].float()
        cum = torch.cumsum(dt[:, q0:q0 + Q].float() * A, dim=1)     # (B,Q,H)
        cum = cum.transpose(1, 2)                                    # (B,H,Q)
        Bc = Bm[:, q0:q0 + Q].float()[:, :, grp]                     # (B,Q,H,N)
        Cc = Cm[:, q0:q0 + Q].float()[:, :, grp]
        seg = cum[..., :, None] - cum[..., None, :]
        decay = torch.where(tril, torch.exp(seg), torch.zeros_like(seg))
        scores = torch.einsum("bign,bjgn->bgij", Cm[:, q0:q0 + Q].float(),
                              Bm[:, q0:q0 + Q].float())[:, grp]      # (B,H,Q,Q)
        y = torch.einsum("bhij,bjhp->bihp", scores * decay, xd)
        y_off = torch.einsum("bihn,bhpn->bihp", Cc, h)
        ys.append(y + y_off * torch.exp(cum).transpose(1, 2)[..., None])
        total = cum[..., -1]                                         # (B,H)
        w = torch.exp(total[..., None] - cum)                        # (B,H,Q)
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bjhp,bhj,bjhn->bhpn", xd, w, Bc)
    return torch.cat(ys, dim=1), h


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int):
    """:func:`ssd_scan_plain`'s scan: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors or raise.  The kernel takes x and
    B/C in one dtype of ``DTYPES``, dt and A in f32, all contiguous;
    ``P % 32 == 0``, ``N`` in ``STATES``, a chunk of at most 256."""
    S = x.shape[1]
    Q = chunk_len(S, chunk)
    if plain(x):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    _check(x, dt, A, Bm, Cm, Q)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev = x.device
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=dev)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    fn = build.function("repro_ssd_scan", _ARGS)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), h.data_ptr(), Bsz, S, H, P, G,
                 N, Q, int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0


def _check(x, dt, A, Bm, Cm, Q: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, got {x.device}")
    if x.dim() != 4 or Bm.dim() != 4 or x.numel() == 0:
        raise ValueError(f"want x (B,S,H,P), Bm/Cm (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    want = {"dt": (dt, (Bsz, S, H), torch.float32),
            "A": (A, (H,), torch.float32),
            "Bm": (Bm, (Bsz, S, G, N), x.dtype),
            "Cm": (Cm, (Bsz, S, G, N), x.dtype)}
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be one of {DTYPES}, got {x.dtype}")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be {dtype} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError("ssd_scan's inputs must be contiguous")
    if H % G or P % COLS or N not in STATES or Q > MAX_CHUNK:
        raise ValueError(f"the kernel takes H % G == 0, P % {COLS} == 0, N "
                         f"in {STATES} and a chunk of at most {MAX_CHUNK}; "
                         f"got H={H}, G={G}, P={P}, N={N}, chunk={Q}")
