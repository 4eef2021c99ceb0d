"""stablelm-3b — dense, MHA (kv = heads), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab=50304,
    norm="ln",
    act="silu",
    remat="full",
)

SMOKE = shrink(CONFIG)
