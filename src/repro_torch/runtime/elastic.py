"""Elastic re-meshing: restart the job at a different device count *or a
different hardware mix*; the port of ``repro/runtime/elastic.py``.

Checkpoints are mesh-agnostic (whole logical arrays in the reference's
layout), so scaling in or out is: form the new group → rebuild the plan
(the sharding rules give the new blocks) → restore the committed
checkpoint into it (:meth:`~repro_torch.core.planner.ExecutionPlan.
restore_state` cuts each rank's blocks from the whole tree).  The batch
schedule is kept consistent by preserving the *global* batch size: dp
changes only each replica's rows.

A plan runs on a process group of its own.  The reference is one process
holding every device, and re-meshes over a subset of ``jax.devices()``;
here each rank is a process, and a plan's mesh is the whole default group.
So every membership change forms a new *generation* of the group
(:func:`~repro_torch.launch.mesh.form_generation`) whose ranks are exactly
the new plan's, and :func:`plan_for_cluster` and :meth:`ElasticContext.
rebalance` build the mesh over that generation's world.  A device index
of the reference (the position in the flat device list that
:class:`HostTopology` deals to hosts) is the rank a process had at launch.

Two re-mesh flavours, as the reference's:

- :meth:`ElasticContext.remesh` — same hardware, different count
  (straggler eviction: a flagged host is excluded and the job resumes on
  N−k hosts).
- :meth:`ElasticContext.rebalance` — a *different hardware mix*: given the
  cluster's per-device-group :class:`ClusterSpec`, the heterogeneity-aware
  search picks a fresh strategy, the balancer re-splits batch/layers in
  proportion to each group's effective FLOP/s, and the checkpoint restores
  into the new plan.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core.cost_model import (ClusterSpec, DeviceGroup,
                                         StrategySpec, WorkloadMeta)
from repro_torch.core.planner import compile_plan, mesh_for_strategy
from repro_torch.launch.mesh import mesh_shape


def search_cluster(meta: WorkloadMeta, spec: ClusterSpec, *,
                   overlap: float = 0.5, search_kw: dict | None = None):
    """Best strategy candidate for ``spec``; raises when nothing fits.

    The single entry the elastic paths share (initial planning in the
    controller and :meth:`ElasticContext.rebalance`) — one place for the
    search defaults and the no-feasible-strategy error."""
    from repro_torch.core.auto import search
    cands = search(meta, spec, top_k=1, overlap=overlap,
                   **(search_kw or {}))
    if not cands:
        raise RuntimeError(
            f"no feasible strategy for {meta.name} on "
            + "+".join(f"{g.n_devices}×{g.hw.name}" for g in spec.groups))
    return cands[0]


def plan_for_cluster(model, meta: WorkloadMeta, spec: ClusterSpec, *,
                     device_type: str = "cuda", overlap: float = 0.5,
                     search_kw: dict | None = None):
    """Search ``spec`` and compile the winning plan over the current
    generation's world (the default process group, whose size must be
    ``spec``'s device count).

    Returns ``(plan, candidate)``.  The placement is attached only on
    mixed-hardware clusters, keeping homogeneous plans identical to the
    spec-less planner's (compile_plan's documented contract).
    """
    cand = search_cluster(meta, spec, overlap=overlap, search_kw=search_kw)
    mesh = mesh_for_strategy(cand.strategy, device_type=device_type,
                             cluster_spec=spec)
    plan = compile_plan(
        model, mesh, strategy=cand.strategy, cluster_spec=spec,
        workload_meta=meta,
        placement=None if spec.is_homogeneous else cand.placement,
        overlap=overlap)
    return plan, cand


@dataclasses.dataclass
class ElasticContext:
    """Rebuild (plan, params, opt_state) from a checkpoint on a new mesh."""
    model: Any
    optimizer: Any

    def remesh(self, ckpt: CheckpointManager, new_mesh,
               strategy: StrategySpec | None = None, *,
               cluster_spec: ClusterSpec | None = None,
               workload_meta: WorkloadMeta | None = None,
               placement=None, overlap: float = 0.0):
        """→ (step, plan, params, opt_state, extra) on ``new_mesh``.

        ``cluster_spec`` + ``workload_meta`` make the rebuilt plan carry a
        balanced heterogeneous placement (per-group batch shares) when the
        new hardware is mixed; a pre-computed ``placement`` (from the
        search) is attached as-is.  Every rank reads the checkpoint whole
        and keeps its blocks.  Raises FileNotFoundError when no committed
        checkpoint exists.
        """
        plan = compile_plan(self.model, new_mesh, strategy=strategy,
                            cluster_spec=cluster_spec,
                            workload_meta=workload_meta,
                            placement=placement, overlap=overlap)
        out = plan.restore_state(ckpt, self.optimizer)
        if out is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {ckpt.directory}")
        step, tree, extra = out
        return step, plan, tree["params"], tree["opt"], extra

    def rebalance(self, ckpt: CheckpointManager,
                  cluster_spec: ClusterSpec,
                  workload_meta: WorkloadMeta, *, new_mesh=None,
                  device_type: str = "cuda", overlap: float = 0.5,
                  search_kw: dict | None = None,
                  hardware: dict | None = None):
        """Re-mesh onto a **different hardware mix**.

        Runs the heterogeneity-aware strategy search over ``cluster_spec``
        (slowest-group-dominates cost, per-group HBM pruning), then
        restores the checkpoint into the winning plan — which carries the
        exact placement the search scored.  The plan's
        ``placement.batch_slices()`` tells the data loader each group's
        throughput-proportional share of the (unchanged) global batch.

        The winning strategy is only known after the search, so the mesh
        is normally built here (``new_mesh=None``) over the current
        generation's world (:func:`~repro_torch.launch.mesh.
        form_generation` made it of exactly the surviving ranks).  A
        caller-supplied mesh is validated against the winner — a mesh
        realising a different (dp, tp, pp) would silently train a
        different parallelism than the placement describes.

        ``search_kw`` forwards to :func:`repro_torch.core.auto.search`
        (e.g. ``max_pp=1`` to stay in the checkpoint's non-pipelined
        parameter layout — pipelined plans pad params per stage, so a live
        re-plan across that boundary would need a layout migration).

        ``hardware`` maps device-group names to replacement ``Hardware``
        tables (typically :class:`~repro_torch.core.calibrate.
        CalibratedHardware` from the profiler): the search and the
        resulting placement then price with *measured* rates — the
        drift-triggered continuous rebalance path.  Groups not named keep
        their prior table.
        """
        if hardware:
            from repro_torch.core.calibrate import refit_spec
            cluster_spec = refit_spec(cluster_spec, hardware)
        cand = search_cluster(workload_meta, cluster_spec, overlap=overlap,
                              search_kw=search_kw)
        strat = cand.strategy
        if new_mesh is None:
            new_mesh = mesh_for_strategy(strat, device_type=device_type,
                                         cluster_spec=cluster_spec)
        else:
            shape = mesh_shape(new_mesh)
            dp = shape.get("pod", 1) * shape.get("data", 1)
            realized = (dp, shape.get("model", 1), shape.get("stage", 1))
            if realized != (strat.dp, strat.tp, strat.pp):
                raise ValueError(
                    f"new_mesh realises dp×tp×pp={realized} but the "
                    f"search picked {strat.describe()} — build the mesh "
                    f"with mesh_for_strategy(strategy) or omit new_mesh")
        return self.remesh(ckpt, new_mesh, strategy=strat,
                           cluster_spec=cluster_spec,
                           workload_meta=workload_meta,
                           placement=(None if cluster_spec.is_homogeneous
                                      else cand.placement), overlap=overlap)


def shrink_devices(devices, exclude_hosts: set, *, topology=None,
                   host_of=None):
    """Filter a device list to exclude flagged hosts (straggler eviction).

    Host-keyed, like :meth:`HostTopology.without`: pass ``topology`` (a
    :class:`HostTopology`) to use its device→host mapping (in the port the
    devices are launch ranks), or nothing to read each device's
    ``process_index``, as the reference reads a JAX device's.

    .. deprecated::
        The ``host_of`` *callable* form is deprecated — it was the one
        API in the eviction path keyed on a mapping function rather than
        on hosts.  Pass ``topology=`` instead.
    """
    if host_of is not None:
        warnings.warn(
            "shrink_devices(host_of=) is deprecated: pass "
            "topology=HostTopology(...) — the eviction APIs are keyed on "
            "hosts (like HostTopology.without), not on mapping callables",
            DeprecationWarning, stacklevel=2)
    elif topology is not None:
        host_of = topology.host_of
    else:
        host_of = (lambda d: d.process_index)
    exclude = set(exclude_hosts)
    return [d for d in devices if host_of(d) not in exclude]


def grow_devices(devices, new_hosts, *, topology):
    """Device list after admitting ``new_hosts`` (grow counterpart of
    :func:`shrink_devices`).

    ``new_hosts`` are :class:`SimHost` entries joining ``topology``
    (host-keyed, like :meth:`HostTopology.with_host` — duplicate ids and
    overlapping explicit offsets are loud errors); ``devices`` is the flat
    backing list (the launch ranks).  Returns ``(device_list,
    grown_topology)`` so the caller can re-mesh over exactly the devices
    the grown topology owns.
    """
    grown = topology
    for h in new_hosts:
        grown = grown.with_host(h)
    return grown.devices(devices), grown


# ---------------------------------------------------------------------------
# simulated multi-host topology (the launch ranks dealt to hosts)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimHost:
    """One simulated host: ``n_devices`` consecutive devices of one kind.

    ``offset`` is the host's first index into the flat device list (the
    launch ranks); it is assigned by :class:`HostTopology`
    (declaration-order packing) and **preserved across eviction**, so a
    surviving host keeps its original ranks rather than sliding down onto
    the evicted host's.
    """
    host: int
    hw: Any                    # core.cost_model.Hardware
    n_devices: int
    offset: int = -1           # assigned by HostTopology when < 0


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """Partition the flat device list (the launch ranks) into simulated
    hosts.

    Devices are dealt to hosts in declaration order (host 0 gets the first
    ``n_devices`` ranks, …).  The topology is the controller's source of
    truth for

    - ``cluster_spec()``: the per-hardware-group view the cost model and
      hetero balancer consume (consecutive same-hardware hosts merge
      into one :class:`DeviceGroup`),
    - ``host_of``: device → host id (feeds :func:`shrink_devices`),
    - ``devices``: the ranks of the next generation of the process group,
      in host order,
    - ``without(hosts)``: the surviving topology after eviction.
    """
    hosts: tuple

    def __post_init__(self):
        fixed, off = [], 0
        for h in self.hosts:
            if h.offset < 0:
                h = dataclasses.replace(h, offset=off)
            fixed.append(h)
            off = h.offset + h.n_devices
        object.__setattr__(self, "hosts", tuple(fixed))

    @classmethod
    def uniform(cls, n_hosts: int, devices_per_host: int, hw
                ) -> "HostTopology":
        return cls(hosts=tuple(SimHost(h, hw, devices_per_host)
                               for h in range(n_hosts)))

    @property
    def n_devices(self) -> int:
        return sum(h.n_devices for h in self.hosts)

    @property
    def host_ids(self) -> tuple:
        return tuple(h.host for h in self.hosts)

    def host_of(self, device) -> int:
        """Map a device (by position in the flat device list: a launch
        rank) to its simulated host."""
        idx = device.id if hasattr(device, "id") else int(device)
        for h in self.hosts:
            if h.offset <= idx < h.offset + h.n_devices:
                return h.host
        raise ValueError(f"device index {idx} outside the topology's "
                         f"device ranges "
                         f"{[(h.offset, h.offset + h.n_devices) for h in self.hosts]}")

    def devices(self, all_devices, exclude: set = frozenset()) -> list:
        """The topology's device list minus excluded hosts (in host order).

        Each host contributes its *original* flat-device range — after an
        eviction the survivors keep their own ranks (the evicted host's
        are simply absent)."""
        need = max(h.offset + h.n_devices for h in self.hosts)
        if len(all_devices) < need:
            raise ValueError(
                f"topology wants device indices up to {need}, have "
                f"{len(all_devices)}")
        out = []
        for h in self.hosts:
            if h.host not in exclude:
                out.extend(all_devices[h.offset:h.offset + h.n_devices])
        return out

    def cluster_spec(self) -> ClusterSpec:
        """Per-group hardware view: consecutive same-hardware hosts merge."""
        groups = []
        for h in self.hosts:
            if groups and groups[-1].hw.name == h.hw.name:
                groups[-1] = dataclasses.replace(
                    groups[-1], n_devices=groups[-1].n_devices + h.n_devices)
            else:
                groups.append(DeviceGroup(
                    f"{h.hw.name}#{len(groups)}", h.hw, h.n_devices))
        return ClusterSpec(groups=tuple(groups))

    def group_hosts(self) -> dict:
        """``cluster_spec()`` group name → member host ids (same merge)."""
        out: dict = {}
        names: list = []
        for h in self.hosts:
            if names and names[-1][0] == h.hw.name:
                out[names[-1][1]].append(h.host)
            else:
                gname = f"{h.hw.name}#{len(names)}"
                names.append((h.hw.name, gname))
                out[gname] = [h.host]
        return out

    def without(self, evicted: set) -> "HostTopology":
        """The surviving topology after evicting ``evicted`` hosts."""
        keep = tuple(h for h in self.hosts if h.host not in evicted)
        if not keep:
            raise ValueError("eviction would remove every host")
        return HostTopology(hosts=keep)

    def with_host(self, host: SimHost) -> "HostTopology":
        """The grown topology after admitting ``host`` (grow counterpart
        of :meth:`without`).

        A ``host.offset < 0`` is placed **first-fit**: the lowest gap in
        the flat device index space that holds ``n_devices`` — so a
        re-admitted host reclaims the device range an eviction vacated
        rather than extending the flat list forever.  An explicit offset
        is honoured but must not overlap a live host's range.  Duplicate
        host ids and non-positive device counts are loud errors.
        """
        if host.n_devices <= 0:
            raise ValueError(
                f"host {host.host} offers n_devices={host.n_devices}; "
                "a joining host must bring at least one device")
        if host.host in self.host_ids:
            raise ValueError(
                f"host {host.host} is already a member "
                f"(hosts={self.host_ids}); evict it first or join under "
                "a fresh id")
        ranges = sorted((h.offset, h.offset + h.n_devices)
                        for h in self.hosts)
        if host.offset < 0:
            # first-fit: gaps between live ranges, then the tail
            cursor = 0
            placed = None
            for lo, hi in ranges:
                if lo - cursor >= host.n_devices:
                    placed = cursor
                    break
                cursor = max(cursor, hi)
            host = dataclasses.replace(
                host, offset=cursor if placed is None else placed)
        else:
            lo, hi = host.offset, host.offset + host.n_devices
            for rlo, rhi in ranges:
                if lo < rhi and rlo < hi:
                    raise ValueError(
                        f"host {host.host} requests device range "
                        f"[{lo}, {hi}) overlapping a live host's "
                        f"[{rlo}, {rhi})")
        grown = sorted(self.hosts + (host,), key=lambda h: h.offset)
        return HostTopology(hosts=tuple(grown))
