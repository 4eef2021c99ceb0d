"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without a CUDA device
(the kernels have no CPU mode).  Imports neither JAX nor the reference, so
it runs on a machine with PyTorch alone::

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes the main path does not reach: ragged tails, Sk < Sq, other group
sizes and head_dim 128, and the rest of the dense family's head dims 80
and 256 (groups 1, 2 and 8); for the flash forward and backward also
whole
tiles at the training heads and at D=128, a second launch equal bit for
bit, and one launch per wrapper call in bf16 and f32 (each dtype has its
kernel: bf16 the tensor cores, f32 the FMA pipes); for the loss head,
ragged token counts, a padded vocab (vocab < Vp), a label in the last real
column, the training step's full head (T = 8188, E = 2048, V = 32000) and
a second launch equal bit for bit, and the vocab-shard loss head
(``xent_vocab_shard``) on a shard at an offset, labels on both sides of
it, on the card against the CPU and against the plain forward on the
shard's columns; for paged decode, one slot filling
the block table at B=1, a slot of one page and a second launch equal bit
for bit; for the SSD scan,
chunks from 8 to 256 (a ragged 40 and mamba2's prefill shape among them),
several groups and batch rows, head dims 32 and 64, states 16 to 128, bf16
and f32 inputs (tolerance 5e-4, the reference's), and a second launch
equal bit for bit;
for the int8 quantize and dequantize, bit for bit: blocks of 3 to 2^22
elements (both kernel paths, vector and scalar accesses), f32 and bf16,
an input that is not 16-byte aligned, NaNs, and ``quantize_int8`` on the
card against the CPU; for the compressor's fused error-feedback encode
(``ef_absmax``, ``ef_requant``, ``ef_decode``), bit for bit against their
plain versions: f32 and bf16, with and without a carried error, a NaN, an
all-zero leaf, one CTA (2048 elements) and many, unaligned views, a
second launch, and ``compressed_psum_tree`` against
``compressed_psum_plain`` leaf by leaf over NCCL in a world of one; and
the multimodal families' shapes: the flash forward and backward at
seamless's 16/16 heads of 64 (the encoder non-causal, the cross-attention
at Sq ≠ Sk, the decoder at a ragged length) and qwen2-vl's 12/2 of 128,
the loss head at E = 1536 (V = 152064) and E = 1024 (V = 256256).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash, paged
from repro_torch.kernels.quant.ops import quant as quant_op
from repro_torch.kernels.quant.quant import (dequantize, dequantize_plain,
                                             ef_absmax, ef_absmax_plain,
                                             ef_decode, ef_decode_plain,
                                             ef_requant, ef_requant_plain,
                                             quantize, quantize_plain)
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.xent import ops as xent_ops
from repro_torch.kernels.xent import xent

from torch_harness import TOL, TOLS, close, paged_inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


#: the rest of the dense family's head dims: stablelm-3b's 80 and
#: gemma-2b's 256, groups 1, 2 and 8, ragged tails and cross shapes
NEW_HEAD_DIMS = [
    (100, 100, 32, 32, 80, True),    # stablelm's heads, ragged (G=1)
    (130, 260, 8, 1, 80, False),     # cross shape, G=8
    (100, 100, 8, 1, 256, True),     # gemma's heads, ragged (G=8)
    (200, 120, 8, 4, 256, False),    # Sk < Sq, G=2
]


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,H,K,D,causal", [
    (100, 100, 32, 4, 64, True),     # ragged tail, tinyllama heads
    (77, 77, 6, 3, 128, True),       # ragged, G=2, D=128
    (130, 260, 8, 8, 64, False),     # cross shape, MHA
    (64, 40, 4, 1, 64, True),        # Sk < Sq, MQA
] + NEW_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(cuda, Sq, Sk, H, K, D, causal,
                                            dtype):
    g = torch.Generator(device=cuda).manual_seed(Sq)
    tdt = getattr(torch, dtype)
    q = torch.randn((2, Sq, H, D), generator=g, device=cuda).to(tdt)
    k = torch.randn((2, Sk, K, D), generator=g, device=cuda).to(tdt)
    v = torch.randn((2, Sk, K, D), generator=g, device=cuda).to(tdt)
    n0 = flash.flash_attention.launches
    o, lse = flash.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == n0 + 1
    o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal)
    close(o.float().cpu(), o_ref.float().cpu(), TOL[dtype])
    close(lse.cpu(), lse_ref.cpu(), TOL[dtype])


def _flash_inputs(device, B, Sq, Sk, H, K, D, dtype):
    g = torch.Generator(device=device).manual_seed(Sq + Sk + D)
    tdt = getattr(torch, dtype)
    return [torch.randn((B, S, n, D), generator=g, device=device).to(tdt)
            for S, n in ((Sq, H), (Sk, K), (Sk, K))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,D,causal", [
    (2, 1024, 32, 4, 64, True),      # tinyllama's heads, whole tiles
    (2, 1024, 16, 4, 128, True),     # whole tiles at D=128
    (2, 1024, 16, 4, 128, False),
])
def test_flash_kernel_matches_plain_on_card_full_tiles(cuda, B, S, H, K, D,
                                                       causal):
    """The bf16 tensor-core kernel at lengths that are whole tiles, so most
    tiles skip the mask."""
    q, k, v = _flash_inputs(cuda, B, S, S, H, K, D, "bfloat16")
    o, lse = flash.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal)
    close(o.float().cpu(), o_ref.float().cpu(), TOL["bfloat16"])
    close(lse.cpu(), lse_ref.cpu(), TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,H,K,D,causal", [
    (300, 300, 32, 4, 64, True),
    (200, 120, 16, 4, 128, False),
    (300, 300, 16, 8, 80, True),
    (256, 256, 8, 4, 256, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_repeats_bit_for_bit_on_card(cuda, Sq, Sk, H, K, D,
                                                  causal, dtype):
    """No atomics: a second launch on the same inputs gives the same bits."""
    q, k, v = _flash_inputs(cuda, 2, Sq, Sk, H, K, D, dtype)
    first = flash.flash_attention(q, k, v, causal)
    second = flash.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.gpu
def test_fwd_wrappers_launch_once_per_call_in_each_dtype_on_card(cuda):
    """bf16 and f32 dispatch to two kernels; each call counts one launch."""
    for dtype in ("float32", "bfloat16"):
        q, k, v = _flash_inputs(cuda, 1, 128, 128, 8, 2, 64, dtype)
        h, w, labels = _xent_inputs(100, 64, 512, 500, dtype, cuda)
        counts = lambda: (flash.flash_attention.launches,
                          xent.xent_fwd.launches)
        n_flash, n_xent = counts()
        flash.flash_attention(q, k, v)
        assert counts() == (n_flash + 1, n_xent)
        xent.xent_fwd(h, w, labels, 500)
        assert counts() == (n_flash + 1, n_xent + 1)


def _paged_edge_inputs(B, H, K, D, ps, mp, seed=0):
    """Block tables at the edges of the cluster's split: B=1, one slot that
    fills every page of the table; B=3, a slot of one page, a slot that
    fills the table, and an inactive slot (table row 0, pos 0)."""
    P = 1 + B * mp
    q, kp, vp, _, _ = paged_inputs(B, H, K, D, ps, mp, P, seed=seed)
    pos = (np.array([mp * ps - 1], np.int32) if B == 1
           else np.array([ps // 2, mp * ps - 1, 0], np.int32))
    table = np.zeros((B, mp), np.int32)
    free = list(np.random.default_rng(seed).permutation(np.arange(1, P)))
    for b in range(B):
        if pos[b] > 0:
            n = pos[b] // ps + 1
            table[b, :n] = [free.pop() for _ in range(n)]
    return q, kp, vp, table, pos


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,D", [(32, 4, 64), (8, 8, 128), (16, 4, 128),
                                   (8, 4, 64), (32, 32, 80), (16, 8, 80),
                                   (8, 1, 256), (4, 4, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slots", ["ragged", "B=1 full", "edges"])
def test_paged_kernel_matches_plain_on_card(cuda, H, K, D, dtype, slots):
    """Ragged slots (paged_inputs), one slot filling max_pages at B=1, and
    a one-page slot beside a full one and an inactive one; a second launch
    gives the same bits (the cluster merges in rank order)."""
    if slots == "ragged":
        B, ps, mp = 5, 16, 6
        inputs = paged_inputs(B, H, K, D, ps, mp, 1 + B * mp, seed=H + D)
    else:
        inputs = _paged_edge_inputs(1 if slots == "B=1 full" else 3, H, K,
                                    D, 64, 20, seed=H + D)
    q, kp, vp, table, pos = inputs
    tdt = getattr(torch, dtype)
    args = [torch.tensor(a).to(tdt).to(cuda) for a in (q, kp, vp)] + [
        torch.tensor(table).to(cuda), torch.tensor(pos).to(cuda)]
    n0 = paged.paged_decode.launches
    out = paged.paged_decode(*args)
    again = paged.paged_decode(*args)
    torch.cuda.synchronize()
    assert paged.paged_decode.launches == n0 + 2
    assert torch.isfinite(out).all()
    assert torch.equal(out.view(torch.uint8), again.view(torch.uint8))
    close(out.float().cpu(), paged.paged_decode_plain(*args).float().cpu(),
          TOL[dtype])


@pytest.mark.gpu
def test_paged_kernel_reads_a_bad_page_id_as_the_trash_page(cuda):
    """A physical page id outside the pool is read as page 0 (zeros), so a
    corrupt block table cannot read out of bounds."""
    B, H, K, D, ps, mp = 2, 8, 2, 64, 16, 4
    q, kp, vp, table, pos = paged_inputs(B, H, K, D, ps, mp, 1 + B * mp)
    good = [torch.tensor(a).to(cuda) for a in (q, kp, vp, table, pos)]
    bad_table = good[3].clone()
    bad_table[0, 0] = 10_000
    zero_table = good[3].clone()
    zero_table[0, 0] = 0
    got = paged.paged_decode(*good[:3], bad_table, good[4])
    want = paged.paged_decode(*good[:3], zero_table, good[4])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,H,K,D,causal", [
    (100, 100, 32, 4, 64, True),     # ragged tail, tinyllama heads (G=8)
    (77, 77, 6, 3, 128, True),       # ragged, G=2, D=128
    (130, 260, 8, 8, 64, False),     # cross shape, MHA (G=1)
    (64, 40, 4, 1, 64, True),        # Sk < Sq, MQA (G=4)
    (200, 120, 16, 4, 128, False),   # Sk < Sq, G=4, D=128
] + NEW_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_match_plain_on_card(cuda, Sq, Sk, H, K, D, causal,
                                               dtype):
    _check_flash_bwd(cuda, 2, Sq, Sk, H, K, D, causal, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,D,causal", [
    (1, 2048, 32, 4, 64, True),      # the training shape's heads and length
    (2, 1024, 16, 4, 128, True),     # whole tiles at D=128
    (2, 1024, 16, 4, 128, False),
    (2, 1024, 32, 32, 80, True),     # whole tiles at D=80 and 256
    (2, 1024, 8, 1, 256, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_match_plain_on_card_full_tiles(cuda, B, S, H, K, D,
                                                          causal, dtype):
    """Lengths that are whole tiles, so most tiles skip the mask."""
    _check_flash_bwd(cuda, B, S, S, H, K, D, causal, dtype)


def _flash_bwd_args(device, B, Sq, Sk, H, K, D, causal, dtype):
    """(q, k, v, do, lse, delta, causal) on the card, lse from the forward
    kernel and delta = rowsum(do∘o), as the autograd op builds them."""
    g = torch.Generator(device=device).manual_seed(Sq + Sk)
    tdt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, D), generator=g, device=device).to(tdt)
    k = torch.randn((B, Sk, K, D), generator=g, device=device).to(tdt)
    v = torch.randn((B, Sk, K, D), generator=g, device=device).to(tdt)
    do = torch.randn((B, Sq, H, D), generator=g, device=device).to(tdt)
    o, lse = flash.flash_attention(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).reshape(B, Sq, K, H // K)
    return q, k, v, do, lse, delta, causal


def _check_flash_bwd(device, B, Sq, Sk, H, K, D, causal, dtype):
    args = _flash_bwd_args(device, B, Sq, Sk, H, K, D, causal, dtype)
    n_dq, n_dkv = flash.flash_bwd_dq.launches, flash.flash_bwd_dkv.launches
    dq, dk, dv = flash.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert flash.flash_bwd_dq.launches == n_dq + 1
    assert flash.flash_bwd_dkv.launches == n_dkv + 1
    want = flash.flash_attention_bwd_plain(*args)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        close(got.float().cpu(), ref.float().cpu(), TOLS[dtype].grad)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,H,K,D,causal", [
    (300, 300, 32, 4, 64, True),
    (200, 120, 16, 4, 128, False),
    (300, 300, 16, 8, 80, True),
    (256, 256, 8, 4, 256, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_repeat_bit_for_bit_on_card(cuda, Sq, Sk, H, K, D,
                                                      causal, dtype):
    """No atomics: a second launch on the same inputs gives the same bits."""
    args = _flash_bwd_args(cuda, 2, Sq, Sk, H, K, D, causal, dtype)
    first = (flash.flash_bwd_dq(*args), *flash.flash_bwd_dkv(*args))
    second = (flash.flash_bwd_dq(*args), *flash.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_wrappers_launch_once_per_call_on_card(cuda, dtype):
    args = _flash_bwd_args(cuda, 1, 128, 128, 8, 2, 64, True, dtype)
    counts = lambda: (flash.flash_bwd_dq.launches,
                      flash.flash_bwd_dkv.launches)
    n_dq, n_dkv = counts()
    flash.flash_bwd_dq(*args)
    assert counts() == (n_dq + 1, n_dkv)
    flash.flash_bwd_dkv(*args)
    assert counts() == (n_dq + 1, n_dkv + 1)


def _xent_inputs(T, E, V, vocab, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    h = torch.tensor(rng.standard_normal((T, E)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((E, V)) / np.sqrt(E),
                     dtype=torch.float32)
    labels = rng.integers(0, vocab, T).astype(np.int32)
    labels[0] = vocab - 1                    # the last real column
    tdt = getattr(torch, dtype)
    return (h.to(tdt).to(device), w.to(tdt).to(device),
            torch.tensor(labels, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,V,vocab", [
    (100, 64, 512, 500),     # ragged T, padded vocab
    (257, 96, 1024, 1024),   # E not a multiple of either chunk (32, 64)
    (64, 40, 200, 131),      # V not a multiple of either tile (64, 128)
    (1000, 128, 4096, 4000), # several vocab segments
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_fwd_kernel_matches_plain_on_card(cuda, T, E, V, vocab, dtype):
    h, w, labels = _xent_inputs(T, E, V, vocab, dtype, cuda, seed=T)
    n0 = xent.xent_fwd.launches
    nll, lse = xent.xent_fwd(h, w, labels, vocab)
    torch.cuda.synchronize()
    assert xent.xent_fwd.launches == n0 + 1
    want_nll, want_lse = xent.xent_fwd_plain(h, w, labels, vocab)
    assert torch.isfinite(nll).all() and torch.isfinite(lse).all()
    close(nll.cpu(), want_nll.cpu(), TOL["float32"])
    close(lse.cpu(), want_lse.cpu(), TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("vocab", [32000, 31900])
def test_xent_fwd_kernel_matches_plain_on_card_full_head(cuda, vocab):
    """The training step's loss head in bf16: T = 4·2047, E = 2048,
    V = 32000, whole 128 x 128 tiles and 4 vocab segments."""
    h, w, labels = _xent_inputs(8188, 2048, 32000, vocab, "bfloat16", cuda)
    nll, lse = xent.xent_fwd(h, w, labels, vocab)
    torch.cuda.synchronize()
    want_nll, want_lse = xent.xent_fwd_plain(h, w, labels, vocab)
    close(nll.cpu(), want_nll.cpu(), TOL["float32"])
    close(lse.cpu(), want_lse.cpu(), TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_fwd_kernel_repeats_bit_for_bit_on_card(cuda, dtype):
    """No atomics: the segments' partials merge in a fixed order, so a
    second launch on the same inputs gives the same bits."""
    h, w, labels = _xent_inputs(1000, 128, 4096, 4000, dtype, cuda)
    first = xent.xent_fwd(h, w, labels, 4000)
    second = xent.xent_fwd(h, w, labels, 4000)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_xent_fwd_bf16_refuses_rows_it_cannot_copy(cuda):
    """bf16 rows go 16 bytes at a time: E and V must be multiples of 8."""
    for E, V in ((36, 512), (64, 500)):
        h, w, labels = _xent_inputs(16, E, V, V, "bfloat16", cuda)
        with pytest.raises(ValueError, match="multiples of 8"):
            xent.xent_fwd(h, w, labels)


@pytest.mark.gpu
@pytest.mark.parametrize("C,col0,vocab", [(512, 0, 400), (300, 256, 500),
                                          (1024, 1024, 1500)])
def test_xent_bwd_kernel_matches_plain_on_card(cuda, C, col0, vocab):
    T = 77
    rng = np.random.default_rng(C)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    logits = f32(rng.standard_normal((T, C)))
    lse = f32(rng.standard_normal(T) + 3.0)
    labels = torch.tensor(rng.integers(0, col0 + C, T).astype(np.int32),
                          device=cuda)
    g_nll, g_lse = f32(rng.standard_normal(T)), f32(rng.standard_normal(T))
    want = xent.xent_bwd_plain(logits.clone(), lse, labels, g_nll, g_lse,
                               col0, vocab)
    n0 = xent.xent_bwd.launches
    got = xent.xent_bwd(logits, lse, labels, g_nll, g_lse, col0, vocab)
    torch.cuda.synchronize()
    assert got is logits and xent.xent_bwd.launches == n0 + 1
    close(got.cpu(), want.cpu(), TOL["float32"])


#: the multimodal families' attention shapes: seamless's 16/16 heads of
#: 64, its encoder non-causal and its cross-attention at Sq ≠ Sk (the
#: decoder's ragged S − 1 against the source), qwen2-vl's 12/2 of 128
MULTIMODAL_FLASH = [
    (2, 1024, 1024, 16, 16, 64, False),   # seamless's encoder
    (2, 1023, 512, 16, 16, 64, False),    # seamless's cross-attention
    (2, 1023, 1023, 16, 16, 64, True),    # seamless's decoder, ragged
    (1, 1024, 1024, 12, 2, 128, True),    # qwen2-vl, group 6
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal", MULTIMODAL_FLASH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_at_the_multimodal_shapes_on_card(cuda, B, Sq, Sk, H, K, D,
                                                causal, dtype):
    """The forward (o and lse) and both backward kernels at the multimodal
    families' shapes against the plain versions."""
    q, k, v = _flash_inputs(cuda, B, Sq, Sk, H, K, D, dtype)
    o, lse = flash.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal)
    close(o.float().cpu(), o_ref.float().cpu(), TOL[dtype])
    close(lse.cpu(), lse_ref.cpu(), TOL[dtype])
    _check_flash_bwd(cuda, B, Sq, Sk, H, K, D, causal, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("E,V,vocab", [
    (1536, 152064, 151936),      # qwen2-vl's tied head
    (1024, 256256, 256206),      # seamless's untied 256k head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_at_the_multimodal_heads_on_card(cuda, E, V, vocab, dtype):
    """The fused loss head at the multimodal families' E and V: the
    forward kernel against its plain version, and the differentiable
    head's gradients on the card against the same inputs on the CPU."""
    T = 300
    h, w, labels = _xent_inputs(T, E, V, vocab, dtype, cuda, seed=E)
    nll, lse = xent.xent_fwd(h, w, labels, vocab)
    torch.cuda.synchronize()
    want_nll, want_lse = xent.xent_fwd_plain(h, w, labels, vocab)
    close(nll.cpu(), want_nll.cpu(), TOL["float32"])
    close(lse.cpu(), want_lse.cpu(), TOL["float32"])
    rng = np.random.default_rng(E)
    g = [torch.tensor(rng.standard_normal(T), dtype=torch.float32)
         for _ in range(2)]
    grads = {}
    for dev in ("cpu", "cuda"):
        hh = h.to(dev).requires_grad_(True)
        ww = w.to(dev).requires_grad_(True)
        nll, lse = xent_ops.xent_with_lse(hh, ww, labels.to(dev), vocab)
        grads[dev] = torch.autograd.grad(
            (nll * g[0].to(dev)).sum() + (lse * g[1].to(dev)).sum(),
            (hh, ww))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        close(a.float().cpu(), b.float(), TOLS[dtype].grad)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_with_lse_on_card_matches_cpu(cuda, dtype, monkeypatch):
    """The whole differentiable loss head, several backward chunks, on the
    card against the same inputs on the CPU (plain versions)."""
    monkeypatch.setattr(xent, "BWD_TILE_BYTES", 300 * 256 * 4)
    T, E, V, vocab = 300, 64, 1024, 1000
    h, w, labels = _xent_inputs(T, E, V, vocab, dtype, "cpu", seed=3)
    rng = np.random.default_rng(4)
    g = [torch.tensor(rng.standard_normal(T), dtype=torch.float32)
         for _ in range(2)]
    grads = {}
    for dev in ("cpu", "cuda"):
        hh = h.to(dev).requires_grad_(True)
        ww = w.to(dev).requires_grad_(True)
        nll, lse = xent_ops.xent_with_lse(hh, ww, labels.to(dev), vocab)
        grads[dev] = torch.autograd.grad(
            (nll * g[0].to(dev)).sum() + (lse * g[1].to(dev)).sum(),
            (hh, ww))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        close(a.float().cpu(), b.float(), TOLS[dtype].grad)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_vocab_shard_on_card_matches_plain(cuda, dtype, tmp_path,
                                                monkeypatch):
    """The vocab-shard Function over a world of one (gloo, which carries
    the card's tensors through host memory): the shard ``[c0, c0 + Vs)``
    of a padded head with labels below, inside and past it.  On the card
    against the CPU (the plain kernels), values and gradients, several
    backward chunks, one launch of each kernel per chunk; and the shard's
    nll against the plain forward on its columns: the target logit where
    the shard holds the label, its lse elsewhere."""
    import torch.distributed as dist

    monkeypatch.setattr(xent, "BWD_TILE_BYTES", 300 * 256 * 4)
    T, E, V, vocab, c0, Vs = 300, 64, 2048, 2000, 1024, 1024
    h, w, labels = _xent_inputs(T, E, V, vocab, dtype, "cpu", seed=5)
    labels[:3] = torch.tensor([5, 1500, vocab - 1])   # below, in, last
    ws = w[:, c0:c0 + Vs].contiguous()
    rng = np.random.default_rng(6)
    g = [torch.tensor(rng.standard_normal(T), dtype=torch.float32)
         for _ in range(2)]
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        out, grads = {}, {}
        for dev in ("cpu", "cuda"):
            hh = h.to(dev).requires_grad_(True)
            ww = ws.to(dev).requires_grad_(True)
            n0 = (xent.xent_fwd.launches, xent.xent_bwd.launches)
            nll, lse = xent_ops.xent_vocab_shard(hh, ww, labels.to(dev), c0,
                                                 vocab, None)
            grads[dev] = torch.autograd.grad(
                (nll * g[0].to(dev)).sum() + (lse * g[1].to(dev)).sum(),
                (hh, ww))
            out[dev] = (nll.cpu(), lse.cpu())
            if dev == "cuda":
                torch.cuda.synchronize()
                chunks = -(-Vs // xent.bwd_chunk(T, Vs))
                assert (xent.xent_fwd.launches - n0[0],
                        xent.xent_bwd.launches - n0[1]) == (1, chunks)
    finally:
        dist.destroy_process_group()
    for a, b in zip(out["cuda"], out["cpu"]):
        close(a, b, TOLS[dtype].fwd)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        close(a.float().cpu(), b.float(), TOLS[dtype].grad)
    nll_p, lse_p = xent.xent_fwd_plain(h, ws, labels - c0, vocab - c0)
    own = (labels >= c0) & (labels < c0 + Vs)
    close(out["cuda"][1], lse_p, TOLS[dtype].fwd)
    close(out["cuda"][0], torch.where(own, nll_p, lse_p), TOLS[dtype].fwd)


def _ssd_inputs(B, S, H, P, G, N, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    tdt = getattr(torch, dtype)
    x = f32(rng.standard_normal((B, S, H, P))).to(tdt)
    dt = f32(np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)))
    A = f32(-np.exp(0.3 * rng.standard_normal(H)))
    Bm = f32(0.3 * rng.standard_normal((B, S, G, N))).to(tdt)
    Cm = f32(0.3 * rng.standard_normal((B, S, G, N))).to(tdt)
    return x, dt, A, Bm, Cm


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 64, 4, 64, 1, 128, 8),       # chunk 8: eight chunks of one tile
    (2, 64, 8, 32, 2, 16, 16),       # groups, batch rows
    (1, 128, 4, 64, 4, 128, 32),     # one group per head
    (2, 256, 4, 32, 1, 16, 64),
    (1, 512, 8, 64, 2, 128, 128),
    (2, 512, 4, 64, 1, 128, 256),    # the serving chunk, four key tiles
    (1, 96, 2, 32, 1, 64, 96),       # a chunk that is not a tile multiple
    (1, 120, 2, 64, 1, 32, 40),      # ragged: 40 rows, past one 16-row tile
    (1, 512, 64, 64, 1, 128, 256),   # mamba2-1.3b's prefill
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_on_card(cuda, B, S, H, P, G, N, chunk,
                                          dtype):
    """bf16 runs the tensor-core kernel, f32 the FMA one; each against the
    plain version and against a second launch bit for bit."""
    args = _ssd_inputs(B, S, H, P, G, N, dtype, cuda, seed=S + N)
    n0 = ssd.ssd_scan.launches
    y, h = ssd.ssd_scan(*args, chunk=chunk)
    again = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == n0 + 2
    assert y.dtype == h.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert torch.equal(y, again[0]) and torch.equal(h, again[1])
    want_y, want_h = ssd.ssd_scan_plain(*args, chunk=chunk)
    close(y.cpu(), want_y.cpu(), 5e-4)
    close(h.cpu(), want_h.cpu(), 5e-4)


@pytest.mark.gpu
def test_ssd_kernel_raises_on_what_it_does_not_take(cuda):
    args = _ssd_inputs(1, 64, 4, 64, 1, 128, "bfloat16", cuda)
    with pytest.raises(ValueError, match="must divide"):
        ssd.ssd_scan(*args, chunk=48)                 # S % chunk != 0
    x, dt, A, Bm, Cm = _ssd_inputs(1, 512, 2, 64, 1, 128, "float32", cuda)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=512)     # longer than 256
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, chunk=256)
    with pytest.raises(ValueError):                   # P % 32 != 0
        ssd.ssd_scan(*_ssd_inputs(1, 64, 2, 16, 1, 16, "float32", cuda),
                     chunk=64)
    with pytest.raises(ValueError):                   # N not built
        ssd.ssd_scan(*_ssd_inputs(1, 64, 2, 32, 1, 48, "float32", cuda),
                     chunk=64)


def _same(a, b) -> bool:
    if a.dtype.is_floating_point:
        return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return bool(torch.equal(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("block,T", [
    (256, 1 << 20),          # one warp per block, vector loads
    (3, 33),                 # scalar path, tiny blocks
    (4096, 4096 * 5),        # the largest one-warp block
    (6000, 6000 * 7),        # two passes, vector loads
    (5003, 5003 * 2),        # two passes, scalar loads
    (1 << 22, 1 << 22),      # one scale per tensor
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nan", [False, True])
def test_quant_kernels_match_plain_bit_for_bit(cuda, block, T, dtype, nan):
    g = torch.Generator(device=cuda).manual_seed(T)
    x = (torch.randn((T,), generator=g, device=cuda) * 3).to(
        getattr(torch, dtype))
    if nan:
        x[T // 2] = float("nan")
    n0 = (quantize.launches, dequantize.launches)
    q, s = quantize(x, block=block)
    y = dequantize(q, s, block=block)
    torch.cuda.synchronize()
    assert (quantize.launches, dequantize.launches) == (n0[0] + 1, n0[1] + 1)
    qp, sp = quantize_plain(x, block)
    assert _same(q, qp) and _same(s, sp)
    assert _same(y, dequantize_plain(qp, sp, block))
    if nan:
        assert torch.isnan(s[(T // 2) // block])


@pytest.mark.gpu
def test_quant_kernels_take_unaligned_views(cuda):
    base = torch.randn((4097,), device=cuda)
    x = base[1:]                           # 4 bytes past a 16-byte boundary
    q, s = quantize(x, block=1024)
    qp, sp = quantize_plain(x, 1024)
    assert _same(q, qp) and _same(s, sp)
    qb = torch.empty((4097,), dtype=torch.int8, device=cuda)[1:]
    qb.copy_(q)
    assert _same(dequantize(qb, s, block=1024), dequantize_plain(q, s, 1024))
    with pytest.raises(ValueError, match="contiguous"):
        quantize(torch.randn((64, 2), device=cuda)[:, 0], block=64)
    with pytest.raises(ValueError, match="must divide"):
        quantize(x, block=1000)
    assert quant_op(x, block=1024)[0].equal(q)


@pytest.mark.gpu
@pytest.mark.parametrize("with_err", [False, True])
def test_quantize_int8_on_card_equals_cpu(cuda, with_err):
    from repro_torch.optim import grad_compress as gc
    g = torch.Generator().manual_seed(7)
    x = torch.randn((22, 64, 56), generator=g) * 1e-3
    err = torch.randn(x.shape, generator=g) * 1e-6 if with_err else None
    got = gc.quantize_int8(x.to(cuda), None if err is None else err.to(cuda))
    want = gc.quantize_int8(x, err)
    for a, b in zip(got, want):
        assert _same(a.cpu(), b)
    assert _same(gc.dequantize_int8(got[0], got[1]).cpu(),
                 gc.dequantize_int8(want[0], want[1]))


def _ef_counts():
    return (ef_absmax.launches, ef_requant.launches, ef_decode.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [
    (2048, 0),               # the norms: one CTA, one launch for the scale
    (22 * 2048, 0),          # a few CTAs and the final reduction
    (2048 * 5632, 0),        # many CTAs, vector accesses
    ((1 << 20) + 3, 0),      # n % 4 != 0: scalar accesses
    (1 << 20, 1),            # views 4 (2) bytes past an aligned address
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "nan", "zero", "no_err"])
def test_ef_kernels_match_plain_bit_for_bit(cuda, n, offset, dtype, case):
    g = torch.Generator(device=cuda).manual_seed(n + offset)
    dt = getattr(torch, dtype)
    x = (torch.randn((n + offset,), generator=g, device=cuda) * 1e-3).to(
        dt)[offset:]
    err = (torch.randn((n + offset,), generator=g, device=cuda)
           * 1e-5)[offset:]
    if case == "zero":
        x.zero_()
        err.zero_()
    elif case == "nan":
        x[n // 3] = float("nan")
    elif case == "no_err":
        err = None
    n0 = _ef_counts()
    s = ef_absmax(x, err)
    smax = s * 1.5                 # the group's scale, above this rank's
    q2, new_err = ef_requant(x, err, s, smax)
    out = torch.empty((n + offset,), dtype=dt, device=cuda)[offset:]
    ef_decode(q2, smax, out, 3)
    torch.cuda.synchronize()
    assert _ef_counts() == (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    assert _same(s, ef_absmax_plain(x, err))
    pq, pe = ef_requant_plain(x, err, s, smax)
    assert _same(q2, pq) and _same(new_err, pe)
    assert _same(out, ef_decode_plain(pq, smax, torch.empty_like(out), 3))
    assert _same(ef_decode(q2, smax, torch.empty_like(out)),
                 ef_decode_plain(pq, smax, torch.empty_like(out)))
    if case == "nan":
        assert torch.isnan(s).all() and torch.isnan(pe[n // 3])
    if case == "zero":
        assert float(s) == np.float32(1e-30) and not q2.any()
    # a second launch on the same inputs gives the same bits, in place too
    assert torch.equal(ef_absmax(x, err).view(torch.int32),
                       s.view(torch.int32))
    again = None if err is None else err.clone()
    q2b, eb = ef_requant(x, again, s, smax, again)
    assert torch.equal(q2b, q2)
    assert torch.equal(eb.view(torch.int32), new_err.view(torch.int32))


@pytest.mark.gpu
def test_compressed_psum_tree_on_card_equals_plain(cuda, tmp_path):
    import torch.distributed as dist

    from repro_torch.optim import grad_compress as gc
    g = torch.Generator(device=cuda).manual_seed(11)
    shapes = {"norm": (2048,), "wq": (4, 2048, 256), "wk": (4, 2048, 64),
              "odd": (1001,)}
    grads = {k: torch.randn(v, generator=g, device=cuda) * 1e-3
             for k, v in shapes.items()}
    grads["bf16"] = (torch.randn((3, 4096), generator=g, device=cuda)
                     * 1e-3).bfloat16()
    err = {k: torch.randn(v.shape, generator=g, device=cuda) * 1e-5
           for k, v in grads.items()}
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        want = {k: gc.compressed_psum_plain(grads[k], None, err[k])
                for k in grads}
        n0 = _ef_counts()
        got_g, got_e = gc.compressed_psum_tree(
            {k: v.clone() for k, v in grads.items()}, None,
            {k: v.clone() for k, v in err.items()})
        torch.cuda.synchronize()
        assert _ef_counts() == tuple(c + len(grads) for c in n0)
        for k in grads:
            assert _same(got_g[k], want[k][0]), k
            assert _same(got_e[k], want[k][1]), k
        out, new_err = gc.compressed_psum(grads["wq"], None, err["wq"])
        assert _same(out, want["wq"][0]) and _same(new_err, want["wq"][1])
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_ef_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.randn((64, 2), device=cuda)
    s = ef_absmax(x)
    n0 = _ef_counts()
    with pytest.raises(ValueError, match="contiguous"):
        ef_absmax(x[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        ef_absmax(x, torch.zeros((2, 64), device=cuda).t())
    with pytest.raises(ValueError, match="contiguous"):
        ef_absmax(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        ef_requant(x[:, 0], None, s, s)
    with pytest.raises(ValueError, match="contiguous"):
        ef_requant(x, None, s, s, torch.empty((2, 64), device=cuda).t())
    q2, _ = ef_requant(x, None, s, s)
    with pytest.raises(ValueError, match="contiguous"):
        ef_decode(q2.t(), s, torch.empty_like(x).t())
    with pytest.raises(ValueError, match="contiguous"):
        ef_decode(q2, s, torch.empty_like(x).t())
    assert _ef_counts() == (n0[0], n0[1] + 1, n0[2])


def _elastic_rank(rank: int, store: str, ckpt: str, out: str) -> None:
    """One of two ranks on the card over gloo (NCCL refuses two ranks on
    one device) running ``train --hosts 2`` with host 1 slowed."""
    import json
    import os

    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.launch.mesh import leave_group

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    flash.flash_attention.launches = xent.xent_fwd.launches = 0
    # the kernels take head dims 64, 80, 128 and 256: the smoke's 32 is
    # raised to 64
    res = train.main(["--smoke", "--overrides", "head_dim=64", "--steps",
                      "12", "--batch", "8", "--seq", "64", "--hosts", "2",
                      "--inject-slow", "1:4:5",
                      "--straggler-warmup", "2", "--patience", "2",
                      "--save-every", "4", "--log-every", "4",
                      "--ckpt-dir", ckpt])
    res["launches"] = [flash.flash_attention.launches,
                       xent.xent_fwd.launches]
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({k: res[k] for k in ("final_step", "phase", "events",
                                       "losses", "launches")}, f)
    leave_group()


@pytest.mark.gpu
def test_elastic_eviction_on_the_card(cuda, tmp_path):
    """The elastic runtime on the card: two ranks on ``cuda:0``, host 1
    evicted at the reference CLI test's step, the job resumed on host 0
    through the flash and xent kernels to DONE."""
    import json

    import torch.multiprocessing as mp

    mp.start_processes(_elastic_rank, args=(
        str(tmp_path / "store"), str(tmp_path / "ck"), str(tmp_path)),
        nprocs=2, start_method="spawn")
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    for r in ranks:
        assert (r["final_step"], r["phase"]) == (12, "DONE")
        kinds = [(e["kind"], e.get("hosts")) for e in r["events"]]
        assert ("evict", [1]) in kinds and ("rebalance", None) in kinds
        assert np.isfinite(r["losses"]).all()
    assert ranks[0]["losses"] == ranks[1]["losses"]
    # host 0 trained all 12 steps through the kernels; host 1 until evicted
    assert ranks[0]["launches"][0] > ranks[1]["launches"][0] > 0
    assert ranks[0]["launches"][1] > 0
