"""grok-1-314b — 8 experts of 32768 columns, top-2, GQA 48 q over 8 kv
heads of 128, GeGLU, an untied vocab of 131072.  [hf:xai-org/grok-1]

On the reference's 16-way model axis the 8 experts do not divide, so the
rules prune the ``experts`` dim and split each expert's d_ff
(``expert_mlp``) instead: grok's expert tensor parallelism
(:mod:`repro_torch.models.moe`).  Its recipe is the reference's for the
archs of 50B and more: Adafactor under ZeRO (``repro.launch.dryrun``).
"""
from repro_torch.configs.base import LMCfg, shrink

CONFIG = LMCfg(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    d_ff_expert=32768,
    n_experts=8,
    top_k=2,
    n_shared=0,
    vocab=131072,
    norm="rms",
    act="gelu",
    remat="full",
)

SMOKE = shrink(CONFIG)
