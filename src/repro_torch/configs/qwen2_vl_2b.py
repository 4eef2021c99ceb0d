"""qwen2-vl-2b — VLM backbone: M-RoPE, GQA kv=2, stub vision frontend.
[arXiv:2409.12191; hf]

The vision tower is a stub: the batch carries precomputed (B, 64,
d_model) patch embeddings, adapted by one linear layer and spliced over
the sequence head; M-RoPE gives the patch prefix (t, h, w) grid
positions.  The same configuration as ``repro.configs.qwen2_vl_2b``.
"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    norm="rms",
    act="silu",
    mrope_sections=(16, 24, 24),   # t/h/w bands over head_dim//2 = 64
    tie_embeddings=True,
    frontend="vision",
    frontend_len=64,
    remat="full",
)

SMOKE = shrink(CONFIG, mrope_sections=(4, 6, 6))
