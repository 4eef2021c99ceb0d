"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without a CUDA device
(the kernels have no CPU mode).  Imports neither JAX nor the reference, so
it runs on a machine with PyTorch alone::

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Shapes the main path does not reach: ragged tails, Sk < Sq, other group
sizes and head_dim 128.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import flash, paged

from torch_harness import TOL, close, paged_inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,H,K,D,causal", [
    (100, 100, 32, 4, 64, True),     # ragged tail, tinyllama heads
    (77, 77, 6, 3, 128, True),       # ragged, G=2, D=128
    (130, 260, 8, 8, 64, False),     # cross shape, MHA
    (64, 40, 4, 1, 64, True),        # Sk < Sq, MQA
])
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


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,D", [(32, 4, 64), (8, 8, 128), (16, 4, 128),
                                   (8, 4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain_on_card(cuda, H, K, D, dtype):
    B, ps, mp = 5, 16, 6
    q, kp, vp, table, pos = paged_inputs(B, H, K, D, ps, mp, 1 + B * mp,
                                         seed=H + D)
    tdt = getattr(torch, dtype)
    args = [torch.tensor(a).to(tdt).to(cuda) for a in (q, kp, vp)] + [
        torch.tensor(table).to(cuda), torch.tensor(pos).to(cuda)]
    n0 = paged.paged_decode.launches
    out = paged.paged_decode(*args)
    torch.cuda.synchronize()
    assert paged.paged_decode.launches == n0 + 1
    assert torch.isfinite(out).all()
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
