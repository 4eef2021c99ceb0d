"""tinyllama-1.1b — llama2-arch small, GQA kv=4.  [arXiv:2401.02385; hf]"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
)

SMOKE = shrink(CONFIG)
