"""jamba-v0.1-52b — hybrid: attention and SSD mixers interleaved 1:7,
16 experts top-2 on every other layer.  [arXiv:2403.19887; hf]

A period of 8 blocks (the remat and pipeline unit): position 4 is
attention (32 q heads over 8 kv heads of 128), the rest SSD mixers (128
heads of 64, state 128, chunk 256); odd positions carry the 16-expert MLP,
even positions a dense SwiGLU MLP.  The mixers are mamba2's SSD in place
of Jamba's mamba-1, as in the reference (``repro.configs.jamba_v0_1_52b``).
"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    d_ff_expert=14336,
    n_experts=16,
    top_k=2,
    vocab=65536,
    attn_period=8,
    attn_offset=4,
    norm="rms",
    act="silu",
    remat="full",
)

SMOKE = shrink(CONFIG, attn_period=4, attn_offset=2, n_layers=4)
