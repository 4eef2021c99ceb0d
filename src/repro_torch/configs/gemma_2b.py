"""gemma-2b — MQA (kv=1), GeGLU, head_dim=256, 256k vocab, tied embeddings.
[arXiv:2403.08295; hf]"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    norm="rms",
    act="gelu",
    tie_embeddings=True,
    remat="full",
)

SMOKE = shrink(CONFIG, n_kv_heads=1)
