"""mamba2-1.3b — attention-free SSD (state-space duality), ssm_state=128.
[arXiv:2405.21060; state-spaces/mamba2-1.3b]

d_inner = 2·d_model = 4096, headdim 64 → 64 SSD heads; tied embeddings,
no MLP.  The mixer is the reference's (``repro.models.mamba2``): the
causal conv runs over x only, the projections are stored per role and the
gated RMSNorm runs over (H, P).
"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab=50280,
    ssd_headdim=64,
    ssd_state=128,
    d_conv=4,
    ssd_chunk=256,
    norm="rms",
    tie_embeddings=True,
    remat="full",
)

SMOKE = shrink(CONFIG)
