"""Device meshes over ``torch.distributed``: the port's ``jax.make_mesh``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
``mesh_dim_names`` are the reference's axis names (``pod``, ``stage``,
``data``, ``model``).  It needs the default process group, one rank per
device: ``torchrun`` (or :func:`torch.distributed.init_process_group`) sets
it up; the drivers make a world of one where neither did
(:func:`start_world`).

The elastic runtime gives each plan a process group of its own: the
ranks a run was launched with (:class:`LaunchWorld`, taken over from the
default group that ``torchrun`` or the caller made) keep the launch
store, and each membership change forms the next *generation* of the
default group over a prefix of it (:func:`form_generation`), of exactly
the ranks of the new plan, numbered in the topology's host order; the
others wait outside every group (:func:`leave_group`), as
``torchrun``'s elastic agent re-forms a job's world.  Within a
generation the world is the mesh, as everywhere else in the port.
"""
from __future__ import annotations

import dataclasses
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
    # at once, also when an error propagates: a rank that raised must not
    # wait for peers blocked in a collective with it (the elastic driver
    # leaves its last group with :func:`leave_group` on a normal exit)
    if dist.is_initialized():
        dist.destroy_process_group()
    if store:
        try:
            os.remove(store)
        except FileNotFoundError:
            pass


def leave_group() -> None:
    """Destroy the default process group (if any) once every rank of it
    has come here: each marks its arrival in the group's store and waits
    for the others', so that none closes its connections while another
    still completes a collective or the group's forming over them (gloo
    fails the peer of a rank that left early)."""
    if not dist.is_initialized():
        return
    from torch.distributed.distributed_c10d import _get_default_store
    store = _get_default_store()
    store.set(f"leaving/{dist.get_rank()}", "1")
    store.wait([f"leaving/{r}" for r in range(dist.get_world_size())])
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# generations of the process group (the elastic runtime)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LaunchWorld:
    """The ranks a run was launched with: the store every generation of
    the process group forms over, this process's launch rank, their
    count, and the collectives' backend."""
    store: object
    rank: int
    size: int
    backend: str


def launch_world() -> LaunchWorld:
    """Take over the default process group as the launch world: keep its
    store, rank, size and backend, and leave the group, so that each plan
    forms a generation of its own (:func:`form_generation`).  The store
    must outlive every rank that may leave: ``torchrun``'s agent store, a
    ``FileStore``, or a ``TCPStore`` that a process outside the job
    hosts."""
    if not dist.is_initialized():
        raise RuntimeError("the elastic runtime needs the default process "
                           "group (torchrun, or torch.distributed."
                           "init_process_group) over the launch ranks")
    from torch.distributed.distributed_c10d import _get_default_store
    world = LaunchWorld(store=_get_default_store(), rank=dist.get_rank(),
                        size=dist.get_world_size(),
                        backend=str(dist.get_backend()))
    leave_group()
    return world


def form_generation(world: LaunchWorld, k: int, ranks) -> bool:
    """Leave the current group, then form generation ``k`` of the default
    group over ``world.store``'s prefix ``gen{k}``: of the launch ranks
    ``ranks``, in order (``ranks[0]`` becomes rank 0).  Every rank of
    ``ranks`` must call it with the same ``k``; a rank not in ``ranks``
    only leaves and returns False.  A rank whose group fails to form
    raises (the store's timeout), it never goes on alone."""
    ranks = [int(r) for r in ranks]
    leave_group()
    if world.rank not in ranks:
        return False
    dist.init_process_group(
        world.backend, store=dist.PrefixStore(f"gen{k}", world.store),
        rank=ranks.index(world.rank), world_size=len(ranks))
    return True
