"""Device meshes over ``torch.distributed``: the port's ``jax.make_mesh``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
``mesh_dim_names`` are the reference's axis names (``pod``, ``stage``,
``data``, ``model``).  It needs the default process group, one rank per
device: ``torchrun`` (or :func:`torch.distributed.init_process_group`) sets
it up; the drivers make a world of one where neither did
(:func:`start_world`).
"""
from __future__ import annotations

import math
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: tuple, axes: tuple, *,
              device_type: str = "cuda") -> DeviceMesh:
    """The ranks of the default group laid out as ``shape`` (row-major,
    as ``jax.make_mesh`` lays out devices), its dims named ``axes``.  The
    product of ``shape`` must equal the world size."""
    shape, axes = tuple(int(d) for d in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ "
                         f"in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group "
                           "(torchrun, or torch.distributed."
                           "init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} has {math.prod(shape)} "
                         f"devices; the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_axes(spec: str) -> tuple:
    """``--mesh`` text → (shape, axis names), the reference's reading
    (``repro/launch/train.py::parse_mesh``): one dim is ``data``, two are
    ``data × model``, three ``pod × data × model``."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 1:
        return dims, ("data",)
    if len(dims) == 2:
        return dims, ("data", "model")
    if len(dims) == 3:
        return dims, ("pod", "data", "model")
    raise ValueError(f"--mesh takes 1 to 3 dims, got {spec!r}")


def parse_mesh(spec: str, *, device_type: str = "cuda") -> DeviceMesh:
    return make_mesh(*mesh_axes(spec), device_type=device_type)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: size}, as ``dict(jax_mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def start_world(device: torch.device, store_dir: str) -> tuple:
    """Make the default process group: under ``torchrun`` from its
    environment (each rank on ``cuda:LOCAL_RANK``), else a world of one
    over a ``FileStore`` in ``store_dir``; NCCL on the card, gloo on the
    CPU.  Returns (this rank's device, the FileStore's path or ``""``)
    for :func:`end_world`."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    torchrun = under_torchrun()
    if device.type == "cuda" and torchrun:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.index is not None:
        torch.cuda.set_device(device)
    if torchrun:
        dist.init_process_group(backend)
        return device, ""
    os.makedirs(store_dir, exist_ok=True)
    path = os.path.join(store_dir,
                        f".filestore_{os.getpid()}_{time.time_ns()}")
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    return device, path


def end_world(store: str | None) -> None:
    """Undo :func:`start_world` (``None``: it made no group)."""
    if store is None:
        return
    dist.destroy_process_group()
    if store:
        try:
            os.remove(store)
        except FileNotFoundError:
            pass
