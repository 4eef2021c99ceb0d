"""qwen3-1.7b — dense, GQA kv=8, per-head qk-norm, tied embeddings.
[hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151936,
    norm="rms",
    act="silu",
    qk_norm=True,
    tie_embeddings=True,
    remat="full",
)

SMOKE = shrink(CONFIG)
