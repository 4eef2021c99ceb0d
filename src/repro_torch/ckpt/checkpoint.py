"""Checkpointing: atomic, async, retention-managed — in the reference's
on-disk format, so each package restores the other's checkpoints.

Layout (one directory per step), as ``repro/ckpt/checkpoint.py``::

    <dir>/step_00000123/
        MANIFEST.json       # leaf paths, shapes, dtypes, extra metadata
        arr_00000.npy ...   # one file per leaf, in sorted key-path order
    <dir>/step_00000123.COMMITTED   # atomicity marker (written last)

- **Leaf order**: ``jax.tree.flatten`` sorts dict keys, so ``arr_00000`` is
  the first leaf in sorted key-path order; :func:`repro_torch.tree.flatten`
  walks nested dicts the same way.
- **Atomic**: the payload is written to ``step_N.tmp`` and renamed, then
  the ``COMMITTED`` marker is created; only committed steps are read.
- **Async**: ``save_async`` copies every tensor to host memory first (and
  waits for the device), then writes on a daemon thread; ``wait()`` joins.
- A bf16 leaf is saved widened to f32 (numpy has no bf16); ``restore``
  casts every array to the target leaf's dtype, as the reference does.
- **Many ranks** (data parallelism): every rank holds the same state, so
  only ``rank`` 0 writes; every rank calls ``barrier`` after each save and
  each ``wait()``, so no rank reads or moves on before the write is
  committed; every rank restores.  Where ranks hold parts of the state (a
  pipeline's stages), ``gather`` assembles the whole on rank 0 before each
  save; every rank calls it, as it is collective.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten


def _to_host(tree) -> tuple:
    """(leaf paths, numpy copies in host memory) of a tree of tensors."""
    paths, leaves = flatten(tree)
    return paths, [(t.float() if t.dtype == torch.bfloat16 else t)
                   .detach().cpu().numpy() for t in leaves]


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    rank: int = 0                          # only rank 0 writes
    barrier: Callable | None = None        # every rank's, after each write
    gather: Callable | None = None         # every rank's, before each write

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> str:
        self.wait()
        tree = self._gathered(tree)
        path = os.path.join(self.directory, f"step_{step:08d}")
        if self.rank == 0:
            path = self._write(step, *_to_host(tree), extra or {})
        self._sync()
        return path

    def save_async(self, step: int, tree: Any, *,
                   extra: dict | None = None) -> None:
        self.wait()
        tree = self._gathered(tree)
        if self.rank != 0:
            return
        paths, host = _to_host(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, paths, host, extra or {}),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._sync()

    def _gathered(self, tree: Any) -> Any:
        return tree if self.gather is None else self.gather(tree)

    def _sync(self) -> None:
        if self.barrier is not None:
            self.barrier()

    def _write(self, step: int, paths: list, leaves: list,
               extra: dict) -> str:
        name = f"step_{step:08d}"
        final = os.path.join(self.directory, name)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "paths": paths,
            "shapes": [list(a.shape) for a in leaves],
            "dtypes": [str(a.dtype) for a in leaves],
            "extra": extra,
        }
        for i, leaf in enumerate(leaves):
            np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), leaf)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(final + ".COMMITTED", "w") as f:
            f.write(name)
        self._retain()
        return final

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            name = f"step_{s:08d}"
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.directory, name + ".COMMITTED"))
            except FileNotFoundError:
                pass

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list:
        out = []
        for fn in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.COMMITTED", fn)
            if m and os.path.isdir(os.path.join(self.directory,
                                                f"step_{int(m.group(1)):08d}")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> tuple:
        """Restore into the structure of ``target`` (nested dicts of
        tensors): each leaf comes back with the target leaf's dtype, on its
        device.  A leaf count, path or shape that differs raises
        ``ValueError``.  Returns (tree, extra)."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        tgt_paths, leaves = flatten(target)
        if len(leaves) != len(manifest["paths"]):
            raise ValueError(
                f"checkpoint has {len(manifest['paths'])} leaves, "
                f"target wants {len(leaves)}")
        mismatch = [(a, b) for a, b in zip(manifest["paths"], tgt_paths)
                    if a != b]
        if mismatch:
            a, b = mismatch[0]
            raise ValueError(
                f"checkpoint tree does not match restore target "
                f"({len(mismatch)} leaves differ; first: ckpt {a!r} vs "
                f"target {b!r})")
        out = []
        for i, tgt in enumerate(leaves):
            arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"))
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(
                    f"leaf {manifest['paths'][i]}: ckpt shape {arr.shape} "
                    f"!= target {tuple(tgt.shape)}")
            # a copy into PyTorch's own (aligned) memory: a resumed run then
            # takes the same kernels, and the same sums, as an unbroken one
            out.append(torch.from_numpy(arr).to(device=tgt.device,
                                                dtype=tgt.dtype, copy=True))
        return unflatten(tgt_paths, out), manifest["extra"]

    def restore_latest(self, target: Any):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, target)
        return step, tree, extra
