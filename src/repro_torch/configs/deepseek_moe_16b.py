"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                 # dense-path width (unused: all layers MoE here)
    d_ff_expert=1408,          # fine-grained expert width
    n_experts=64,
    top_k=6,
    n_shared=2,
    vocab=102400,
    norm="rms",
    act="silu",
    remat="full",
)

SMOKE = shrink(CONFIG)
