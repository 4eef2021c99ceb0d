"""Registry of the ported architectures, the reference's ten: the dense
family (tinyllama-1.1b, qwen3-1.7b, gemma-2b, stablelm-3b), mamba2-1.3b,
the moe family (deepseek-moe-16b, grok-1-314b), the hybrid
jamba-v0.1-52b, the vlm qwen2-vl-2b and the encoder–decoder
seamless-m4t-medium."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import LMCfg, shrink  # noqa: F401

_ARCH_MODULES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma-2b": "gemma_2b",
    "stablelm-3b": "stablelm_3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "grok-1-314b": "grok_1_314b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str, smoke: bool = False) -> LMCfg:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


def apply_overrides(cfg: LMCfg, spec: str) -> LMCfg:
    """``cfg`` with the drivers' ``--overrides`` (comma ``k=v``, each value
    read as the field's type) applied."""
    if not spec:
        return cfg
    kv = {}
    for pair in spec.split(","):
        k, v = pair.split("=")
        cur = getattr(cfg, k)
        kv[k] = type(cur)(v) if not isinstance(cur, bool) else v == "True"
    return dataclasses.replace(cfg, **kv)
