"""Virtual devices (Whale abstraction #3), the port of
``repro/core/vdevice.py``.

A :class:`VirtualDevice` is a named group of physical devices; a
:class:`Cluster` owns the physical mesh — a
:class:`torch.distributed.device_mesh.DeviceMesh` built by
:func:`repro_torch.launch.mesh.make_mesh`, one rank per device — and hands
out virtual devices.  Strategy scopes attach subgraphs to virtual devices;
the planner maps a virtual device onto mesh axes (replica groups ride the
``data`` axes, operator shards the ``model`` axis, pipeline stages a
``stage`` axis).

Heterogeneous clusters: a Cluster may carry a
:class:`~repro_torch.core.cost_model.ClusterSpec` describing per-device-
group hardware tables; virtual devices are then tagged with the hardware
they land on, and the planner balances work over the spec.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (end_world, make_mesh, mesh_shape,
                                    start_world, under_torchrun)


@dataclasses.dataclass(frozen=True)
class VirtualDevice:
    """A logical device group = a sub-rectangle of the mesh."""
    name: str
    axes: tuple            # mesh axes this VD spans
    index: int = 0         # which slice along the partitioning axis (stages)
    hardware: str | None = None   # Hardware.name this VD lands on (hetero)

    def size(self, mesh) -> int:
        shape = mesh_shape(mesh)
        return int(math.prod(shape[a] for a in self.axes))


class Cluster:
    """Physical cluster + virtual-device factory (Whale ``wh.cluster``).

    Also the ambient context that strategy scopes and ``wh.sub`` record
    into.  ``mesh`` is a ``DeviceMesh``; without one, ``mesh_shape`` and
    ``axis_names`` build it over the default process group on
    ``device_type`` (``"cuda"`` unless the caller asks for ``"cpu"``), and
    with no shape either it spans the world along ``data``.  Where no
    process group exists, the cluster starts one as the drivers do
    (:func:`~repro_torch.launch.mesh.start_world`: NCCL on the card, gloo
    on the CPU): under ``torchrun`` from its environment, else a world of
    one where the shape holds one device (or none is given), and
    :meth:`close` ends it; any other shape raises, as
    :func:`~repro_torch.launch.mesh.make_mesh` does.
    """

    _active: list = []

    def __init__(self, mesh=None, *, mesh_shape: tuple | None = None,
                 axis_names: tuple | None = None, layout: dict | None = None,
                 spec=None, device_type: str = "cuda"):
        self._store = None
        if mesh is None:
            if not dist.is_initialized() and (
                    under_torchrun() or mesh_shape is None
                    or math.prod(mesh_shape) == 1):
                device = torch.device(device_type)
                if device.type == "cuda" and not torch.cuda.is_available():
                    raise RuntimeError(
                        "CUDA is not available; pass device_type='cpu' to "
                        "build the cluster's mesh on the CPU")
                _, self._store = start_world(
                    device, tempfile.mkdtemp(prefix="wh_cluster_"))
            if mesh_shape is None:
                mesh_shape, axis_names = (dist.get_world_size(),), ("data",)
            axis_names = axis_names or tuple(
                f"ax{i}" for i in range(len(mesh_shape)))
            mesh = make_mesh(tuple(mesh_shape), tuple(axis_names),
                             device_type=device_type)
        self.mesh = mesh
        self.layout = layout or {}
        # per-device-group Hardware tables (cost_model.ClusterSpec) — None
        # means "treat as homogeneous"
        self.spec = spec
        self.taskgraph = None   # filled by the scopes and wh.sub
        self._scope_stack: list = []

    def close(self) -> None:
        """End the world of one this cluster started (nothing otherwise)."""
        store, self._store = self._store, None
        end_world(store)
        if store:
            shutil.rmtree(os.path.dirname(store), ignore_errors=True)

    # --- context management (the `with wh.cluster():` API) ---
    def __enter__(self):
        Cluster._active.append(self)
        from repro_torch.core.ir import TaskGraph
        if self.taskgraph is None:
            self.taskgraph = TaskGraph()
        return self

    def __exit__(self, *exc):
        Cluster._active.pop()
        return False

    @classmethod
    def current(cls) -> "Cluster | None":
        return cls._active[-1] if cls._active else None

    @property
    def shape(self) -> dict:
        """{axis name: size} of the mesh (the reference's ``mesh.shape``)."""
        return mesh_shape(self.mesh)

    # --- heterogeneous hardware tags ---
    def _uniform_hw(self) -> str | None:
        if self.spec is not None and self.spec.is_homogeneous:
            return self.spec.groups[0].hw.name
        return None

    def hardware_for_stage(self, index: int, n_stages: int) -> str | None:
        """Hardware tag for pipeline stage ``index`` of ``n_stages``.

        Delegates to :func:`repro_torch.core.hetero.stage_groups_for` —
        the same dealing the planner prices — so tags always agree with a
        realizable placement.  A layout the planner would reject (groups
        don't tile whole stages) gets no tag rather than a wrong one.
        """
        if self.spec is None:
            return None
        from repro_torch.core.cost_model import StrategySpec
        from repro_torch.core.hetero import stage_groups_for
        per_stage, rem = divmod(self.spec.n_devices, n_stages)
        if rem or per_stage == 0:
            return None
        try:
            sgroups = stage_groups_for(
                self.spec, StrategySpec(dp=per_stage, pp=n_stages))
        except ValueError:
            return None
        return sgroups[index].hw.name

    # --- virtual devices ---
    def _model_axis(self) -> str:
        return ("model" if "model" in self.shape
                else self.mesh.mesh_dim_names[-1])

    def replica_vd(self) -> VirtualDevice:
        axes = tuple(a for a in ("pod", "data") if a in self.shape)
        return VirtualDevice("replica", axes, hardware=self._uniform_hw())

    def split_vd(self) -> VirtualDevice:
        return VirtualDevice("split", (self._model_axis(),),
                             hardware=self._uniform_hw())

    def hybrid_vd(self) -> VirtualDevice:
        """Nested replica{split}: one VD spanning the data AND model axes
        (the subgraph is replicated over data, sharded over model)."""
        axes = tuple(a for a in ("pod", "data") if a in self.shape)
        return VirtualDevice("hybrid", axes + (self._model_axis(),),
                             hardware=self._uniform_hw())

    def stage_vd(self, index: int, n_stages: int | None = None
                 ) -> VirtualDevice:
        ax = ("stage" if "stage" in self.shape
              else self.mesh.mesh_dim_names[0])
        if n_stages is None:
            # the stage axis size IS the pipeline depth on a staged mesh —
            # wh.sub's recording gets tags for free
            n_stages = self.shape.get("stage")
        hw = self._uniform_hw()
        if hw is None and self.spec is not None and n_stages:
            hw = self.hardware_for_stage(index, n_stages)
        return VirtualDevice(f"stage{index}", (ax,), index, hardware=hw)

    @property
    def n_devices(self) -> int:
        return int(math.prod(self.shape.values()))
