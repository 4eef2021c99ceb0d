"""Fused vocab-tiled softmax cross-entropy: the forward kernel and the
elementwise pass of the backward.

Replaces ``repro/kernels/xent/xent.py::_xent_kernel`` (CUDA:
``csrc/xent_fwd.cu``) and the elementwise part of the jnp backward
``repro/kernels/xent/ops.py::_bwd_lse`` (CUDA: ``csrc/xent_bwd.cu``).
:func:`xent_fwd_plain` and :func:`xent_bwd_plain` are their plain PyTorch
versions, which the wrappers run for CPU tensors and the tests and
``chip_smoke.py`` hold the kernels against.  The differentiable ops are in
:mod:`.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, plain

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
# the forward kernel's block per dtype: (token rows, vocab columns per tile,
# blocks resident on one SM) -- bf16 on the tensor cores, f32 on the FMA pipes
FWD_TILE = {torch.bfloat16: (128, 128, 2), torch.float32: (64, 64, 8)}
BWD_TILE_BYTES = 1 << 27     # the backward's one live f32 logits chunk


def xent_fwd_plain(hidden: torch.Tensor, head_w: torch.Tensor,
                   labels: torch.Tensor, vocab: int | None = None):
    """hidden (T, E), head_w (E, V), labels (T,) → (nll, lse) (T,) f32,
    from the full f32 logits; columns ≥ ``vocab`` are masked."""
    logits = hidden.float() @ head_w.float()
    V = head_w.shape[1]
    col = torch.arange(V, device=hidden.device)
    if vocab is not None and vocab < V:
        logits = torch.where(col[None, :] < vocab, logits,
                             torch.full_like(logits, NEG_INF))
    m = logits.amax(-1)
    l = torch.exp(logits - m[:, None]).sum(-1)
    lse = torch.log(l.clamp_min(1e-30)) + m
    hit = col[None, :] == labels.long()[:, None]
    correct = torch.where(hit, logits, torch.zeros_like(logits)).sum(-1)
    return lse - correct, lse


def segments(tokens: int, vocab_cols: int, sms: int,
             dtype: torch.dtype = torch.bfloat16) -> int:
    """Vocab segments per token tile of the forward kernel (one block per
    token tile and segment): as many as one wave of resident blocks holds,
    at least one, at most one per vocab tile."""
    rows, cols, per_sm = FWD_TILE[dtype]
    n_t = -(-tokens // rows)
    n_v = -(-vocab_cols // cols)
    return max(1, min(n_v, per_sm * sms // n_t))


_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def xent_fwd(hidden: torch.Tensor, head_w: torch.Tensor,
             labels: torch.Tensor, vocab: int | None = None):
    """hidden (T, E), head_w (E, V) of one dtype, labels (T,) int →
    (nll, lse) (T,) f32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 or f32, contiguous, int32 labels; in bf16 E and
    V multiples of 8 and 16-byte aligned) or raise.  The dtype picks the
    kernel: bf16 the tensor-core one, f32 the FMA one."""
    if plain(hidden):
        return xent_fwd_plain(hidden, head_w, labels, vocab)
    _check_fwd(hidden, head_w, labels)
    T, E = hidden.shape
    V = head_w.shape[1]
    vocab = V if vocab is None else min(vocab, V)
    dev = hidden.device
    nseg = segments(T, V, torch.cuda.get_device_properties(
        dev).multi_processor_count, hidden.dtype)
    part = torch.empty((nseg, T, 3), dtype=torch.float32, device=dev)
    nll = torch.empty((T,), dtype=torch.float32, device=dev)
    lse = torch.empty_like(nll)
    fn = build.function("repro_xent_fwd", _FWD_ARGS)
    with torch.cuda.device(dev):
        err = fn(hidden.data_ptr(), head_w.data_ptr(), labels.data_ptr(),
                 part.data_ptr(), nll.data_ptr(), lse.data_ptr(), T, E, V,
                 vocab, nseg, int(hidden.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "xent_fwd")
    xent_fwd.launches += 1
    return nll, lse


xent_fwd.launches = 0


def bwd_chunk(tokens: int, vocab_cols: int) -> int:
    """Vocab columns per backward chunk: the f32 (T, chunk) logits tile
    stays within ``BWD_TILE_BYTES`` (a multiple of 256 columns, at least
    256, at most the whole head)."""
    c = BWD_TILE_BYTES // (4 * max(tokens, 1)) // 256 * 256
    return min(vocab_cols, max(256, c))


def xent_bwd_plain(logits: torch.Tensor, lse: torch.Tensor,
                   labels: torch.Tensor, g_nll: torch.Tensor,
                   g_lse: torch.Tensor, col0: int, vocab: int):
    """Rewrite the f32 logits chunk (T, C) of columns [col0, col0 + C) in
    place as d logits = g_nll·(p − onehot) + g_lse·p, p = softmax (0 on
    columns ≥ vocab); returns ``logits``."""
    C = logits.shape[1]
    col = col0 + torch.arange(C, device=logits.device)
    p = torch.where(col[None, :] < vocab, torch.exp(logits - lse[:, None]),
                    torch.zeros_like(logits))
    onehot = (col[None, :] == labels.long()[:, None]).float()
    return logits.copy_(g_nll[:, None] * (p - onehot) + g_lse[:, None] * p)


_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def xent_bwd(logits: torch.Tensor, lse: torch.Tensor, labels: torch.Tensor,
             g_nll: torch.Tensor, g_lse: torch.Tensor, col0: int,
             vocab: int):
    """:func:`xent_bwd_plain`'s pass, in place: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (f32, contiguous, int32
    labels) or raise."""
    if plain(logits):
        return xent_bwd_plain(logits, lse, labels, g_nll, g_lse, col0, vocab)
    _check_bwd(logits, lse, labels, g_nll, g_lse)
    T, C = logits.shape
    fn = build.function("repro_xent_bwd", _BWD_ARGS)
    with torch.cuda.device(logits.device):
        err = fn(logits.data_ptr(), lse.data_ptr(), labels.data_ptr(),
                 g_nll.data_ptr(), g_lse.data_ptr(), T, C, col0, vocab,
                 torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "xent_bwd")
    xent_bwd.launches += 1
    return logits


xent_bwd.launches = 0


def _check_rows(dev, T: int, **rows) -> None:
    for name, t in rows.items():
        want = torch.int32 if name == "labels" else torch.float32
        if (t.device != dev or t.dtype != want or tuple(t.shape) != (T,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be {want} ({T},) contiguous on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")


def _check_fwd(hidden, head_w, labels) -> None:
    if hidden.device.type != "cuda":
        raise ValueError(f"xent_fwd runs on cpu or cuda, got {hidden.device}")
    if hidden.dtype not in DTYPES or head_w.dtype != hidden.dtype:
        raise ValueError(f"hidden and head_w must share a dtype of {DTYPES}, "
                         f"got {hidden.dtype}/{head_w.dtype}")
    if (hidden.dim() != 2 or head_w.dim() != 2
            or head_w.shape[0] != hidden.shape[1] or hidden.numel() == 0
            or head_w.numel() == 0):
        raise ValueError(f"want hidden (T,E), head_w (E,V); got "
                         f"{tuple(hidden.shape)}, {tuple(head_w.shape)}")
    if head_w.device != hidden.device:
        raise ValueError("hidden and head_w must be on one device")
    if not (hidden.is_contiguous() and head_w.is_contiguous()):
        raise ValueError("hidden and head_w must be contiguous")
    if hidden.dtype == torch.bfloat16 and (
            hidden.shape[1] % 8 or head_w.shape[1] % 8
            or hidden.data_ptr() % 16 or head_w.data_ptr() % 16):
        raise ValueError(f"bf16 rows are copied 16 bytes at a time: E and V "
                         f"must be multiples of 8 and the tensors 16-byte "
                         f"aligned, got hidden {tuple(hidden.shape)}, head_w "
                         f"{tuple(head_w.shape)}")
    _check_rows(hidden.device, hidden.shape[0], labels=labels)


def _check_bwd(logits, lse, labels, g_nll, g_lse) -> None:
    if logits.device.type != "cuda":
        raise ValueError(f"xent_bwd runs on cpu or cuda, got {logits.device}")
    if (logits.dtype != torch.float32 or logits.dim() != 2
            or not logits.is_contiguous() or logits.numel() == 0):
        raise ValueError(f"logits must be a non-empty contiguous f32 (T, C) "
                         f"tile, got {tuple(logits.shape)} {logits.dtype}")
    _check_rows(logits.device, logits.shape[0], lse=lse, labels=labels,
                g_nll=g_nll, g_lse=g_lse)
