"""seamless-m4t-medium — encoder-decoder (12L + 12L), 256k vocab, audio stub.
[arXiv:2308.11596; hf]

The speech frontend is a stub: the batch carries precomputed (B, S_src,
d_model) frame embeddings, adapted by one linear layer into the encoder.
RoPE replaces the original relative positions, as in the reference
(``repro.configs.seamless_m4t_medium``).
"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,                # 12 encoder + 12 decoder
    n_enc_layers=12,
    n_dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    norm="ln",
    act="relu",
    gated_mlp=False,
    frontend="audio",
    frontend_len=0,
    remat="full",
)

SMOKE = shrink(CONFIG)
