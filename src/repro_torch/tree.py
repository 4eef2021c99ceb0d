"""Nested dicts of tensors as the port's pytrees.

``jax.tree.flatten`` visits a dict's keys in sorted order, and the
reference's checkpoint numbers its leaves in that order
(``repro/ckpt/checkpoint.py``); :func:`flatten` does the same, so leaf
``i`` is the same leaf in both packages.
"""
from __future__ import annotations

from typing import Callable


def flatten(tree, prefix: str = "") -> tuple:
    """Nested dict → (["a/b/c", …], [leaf, …]) in sorted key-path order.
    A leaf is anything that is not a dict."""
    if not isinstance(tree, dict):
        return [prefix], [tree]
    prefix = f"{prefix}/" if prefix else ""
    paths, leaves = [], []
    for k in sorted(tree):
        p, lv = flatten(tree[k], f"{prefix}{k}")
        paths += p
        leaves += lv
    return paths, leaves


def unflatten(paths: list, leaves: list) -> dict:
    """The inverse of :func:`flatten`."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, which share its
    structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
