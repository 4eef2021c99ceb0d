"""Weight bridge: a reference (``repro``) parameter or training-state tree
→ the port's.

The reference checkpoint stores one array per leaf under its path
(``embed/table``, ``blocks/p0/attn/wq`` …; ``repro/ckpt/checkpoint.py``).
The port keeps the same paths, shapes and layouts (the experts' ``router/w``
in f32 whatever the parameter dtype, ``w_in``, ``w_gate``, ``w_out``
stacked on their ``experts`` dim and ``shared/*`` as the reference's;
grok-1's untied ``head/w`` beside ``embed/table``), so the bridge only
nests the flat mapping and moves it onto a device — and refuses a tree
that does not match the config leaf for leaf.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.models.lm import LMCfg, Model


def leaf_paths(tree: dict, prefix: str = "") -> dict:
    """Nested dict → {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(leaf_paths(v, path + "/"))
        else:
            out[path] = v
    return out


def params_from_numpy(cfg: LMCfg, tree: dict, device) -> dict:
    """``tree``: {leaf path: numpy array} of a reference ``Model.init``
    tree for ``cfg``.  Returns the port's parameter dict on ``device``, in
    the config's parameter dtype.  A missing, extra or misshapen leaf
    raises ``ValueError``."""
    want = leaf_paths(Model(cfg, device="meta").init(0))
    missing = sorted(set(want) - set(tree))
    extra = sorted(set(tree) - set(want))
    if missing or extra:
        raise ValueError(f"param tree does not match {cfg.name}: missing "
                         f"{missing}, unexpected {extra}")
    out: dict = {}
    for path, ref in want.items():
        arr = np.asarray(tree[path])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {arr.shape}, want "
                             f"{tuple(ref.shape)}")
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        with warnings.catch_warnings():
            # read-only input (e.g. a view of a JAX array) is fine: the
            # copy below is what the port keeps
            warnings.filterwarnings("ignore", message=".*not writable")
            src = torch.as_tensor(arr)
        node[leaf] = src.to(device=device, dtype=ref.dtype, copy=True)
    return out


def state_from_numpy(cfg: LMCfg, tree: dict, device) -> dict:
    """``tree``: {leaf path: numpy array} of a reference training state
    ``{"params": …, "opt": {"mu": …, "nu": …}}`` (AdamW's moments have the
    parameters' leaves).  Returns the port's state dict on ``device``; a
    missing, extra or misshapen leaf raises ``ValueError``."""
    parts = {"params": {}, "opt/mu": {}, "opt/nu": {}}
    for path, arr in tree.items():
        head = next((p for p in parts if path.startswith(p + "/")), None)
        if head is None:
            raise ValueError(f"state tree has an unexpected leaf {path!r}")
        parts[head][path[len(head) + 1:]] = arr
    return {"params": params_from_numpy(cfg, parts["params"], device),
            "opt": {m: params_from_numpy(cfg, parts[f"opt/{m}"], device)
                    for m in ("mu", "nu")}}
