"""Whale Engine: strategy → mesh → execution plan → train step, the port
of ``repro/core/planner.py`` as far as data parallelism over the ``pod``
and ``data`` axes (the paper's ``replica``), the explicit cross-pod
gradient reduction and the pipeline over a ``stage`` axis go.

Data parallelism.  The reference leaves the in-pod reduction to GSPMD and
makes only the cross-pod one explicit (planner step 3, "add collective
communication primitives"); here both are explicit ``torch.distributed``
collectives on the groups of a
:class:`~torch.distributed.device_mesh.DeviceMesh`:

- in the pod: ``all_reduce`` of the f32 gradients over ``data``, then a
  division by its size (the mean over the pod's batch);
- across pods: with ``compress_pod``, the int8 error-feedback
  :func:`~repro_torch.optim.grad_compress.compressed_psum_tree` over
  ``pod`` (mean); without it, a plain ``all_reduce`` and division over
  ``pod``.

Every rank draws the same global batch and trains on its rows
(:meth:`ExecutionPlan.batch_slice`, dealt over ``pod`` and ``data`` only,
so the stages of one data replica take the same rows).  Without a stage
axis every rank holds the whole model (replicas) and the same optimizer
state.

The pipeline (``pp > 1``, the paper's ``stage`` and ``pipeline``):
:meth:`ExecutionPlan.pipeline_train_step_fn` runs the multi-rank engine of
:mod:`repro_torch.core.pipeline` on the mesh's ``stage`` groups under
``gpipe`` or ``1f1b``, each rank holding its stage's rows
(:meth:`ExecutionPlan.init_pipeline_params`).  Nested in it, as Whale's
Case 4 nests them: a ``model`` axis splits every stage (the plan's rules),
and the stages are replicated over ``data`` and ``pod``, their gradients
averaged over both.  The layout is the reference's ``staged_specs``
(``param_specs`` under ``pp > 1``), which shards nothing over the data
axes: a pipelined plan with ZeRO runs exactly as ZeRO 0, as the
reference's pipelined executor does.

Heterogeneous placement (the paper's §5): on a mixed-hardware
:class:`~repro_torch.core.cost_model.ClusterSpec` with the workload's
``workload_meta``, :func:`compile_plan` carries the balanced
:class:`~repro_torch.core.hetero.HeteroPlacement`, as the reference does.
Its ``layer_alloc`` sets :meth:`ExecutionPlan.stage_layers` (uneven
stages through the pipeline engine), and under ``pp == 1`` its per-group
``batch_shares`` deal uneven rows to the data replicas
(:meth:`ExecutionPlan.batch_slice`); the data-parallel step then weights
each rank by its token count (:meth:`ExecutionPlan.train_step_fn`), as it
does for a ``loss_mask``.

The compressed cross-pod reduction under a split or ZeRO: a plan compiled
with ``compress_pod`` keeps ZeRO inside each pod (its data axes are
``data`` alone; the pods are replicas, as in the reference's step, which
is manual over ``pod`` with GSPMD splitting the rest inside), and each
rank compresses its block of every leaf against the whole leaf's scale
(the block's abs-max all-reduced over the axes the leaf is cut on).  So
ZeRO-1 and ZeRO-3 hand the optimizer what ZeRO-0 does, bit for bit.

Tensor parallelism and ZeRO (the paper's ``split``, and the optimizer
state and parameters sharded over ``data``): the plan's
:class:`~repro_torch.core.sharding.ShardingRules` are the reference's
(:func:`~repro_torch.core.sharding.rules_for_strategy`), and so are its
``param_specs`` and AdamW's :meth:`ExecutionPlan.state_layout`.  Each
rank holds its block of every leaf (:meth:`ExecutionPlan.init_params`
draws the whole model and keeps it), and the model runs under the
rules: head-parallel attention, column/row-parallel MLP, whole experts
split over ``model`` (the expert split, ``ep > 1``, which shares the
axis with ``tp`` as the reference's ``StrategySpec.model_parallel`` says;
the experts' gradients are summed over the data axes only, as every
split leaf's), or where the axis does not divide the experts (grok-1's 8
on the reference's 16-way axis) every expert's d_ff columns over it
(expert tensor parallelism, ``ep = 1``), a vocab-parallel embedding and
loss head, each collective an explicit
``torch.distributed`` call on the mesh's groups where GSPMD would place
it.  The data-parallel reduction works per local leaf, as before; under
ZeRO-3 a leaf sharded over the data axes is gathered at its use and its
gradient comes back summed by the backward's reduce-scatter, so the step
only divides it.  ZeRO-1/2 keep the optimizer state of this rank's
slices and all-gather the updated parameter slice (zero 2 runs as zero
1, as in the reference); the clip norm sums each leaf's squares over the
axes it is split over, and Adafactor's factored means are the whole
leaf's, summed over the same axes (the optimizer is handed each leaf's
spec); its state is laid out as the blocks it updates
(:meth:`ExecutionPlan.state_layout`), which the checkpoint gathers and
restores.  Still refused, naming its ROADMAP item: ZeRO with uneven
batch shares, and the multimodal families (vlm, encdec) split over
``model`` or under ZeRO.

The encoder–decoder family pipelines over the two-tower cut, as the
reference routes it: at ``pp = 2`` :meth:`ExecutionPlan.stage_layers`
is ``(n_enc, n_dec)``, :meth:`~ExecutionPlan.pipeline_train_step_fn`
runs :func:`~repro_torch.core.pipeline.make_encdec_pipeline_train_step`
and :meth:`~ExecutionPlan.init_pipeline_params` draws the standard,
stage-replicated tree.

Serving (the reference's ``jit_prefill``, ``jit_serve_step``,
``jit_serve_step_paged``): :meth:`ExecutionPlan.prefill_fn`,
:meth:`~ExecutionPlan.serve_step_fn` and
:meth:`~ExecutionPlan.serve_step_paged_fn` return plain functions that
enter the plan's rules on every call and run without autograd; the decode
states are laid out by the reference's :meth:`~ExecutionPlan.state_specs`
and :meth:`~ExecutionPlan.paged_state_specs`, slots over the data axes
(:meth:`~ExecutionPlan.slot_block`).  A model with experts (the moe
family, the hybrid's odd blocks) serves under the same rules: its
experts stay whole over ``model`` and each step's combine
is all-reduced once, each slot's token routed as a sequence of one, and
no collective runs over data.  Refused, each naming its ROADMAP item:
serving inside a pipeline, ZeRO-3's data-sharded parameters, and decode
in the ``repeat`` layout.

The annotation API's entry points (the paper's Cases 1–5):
:func:`strategy_from_taskgraph` reads the strategy off the scopes a
:class:`~repro_torch.core.vdevice.Cluster` recorded and
:func:`compile_plan_from_cluster` compiles it over the cluster's mesh, as
``graph_opt.compile_nested_plan`` does after lowering; the M6 nesting
``replica{split[experts]}`` lowers to ``ep > 1`` and runs as above.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core import sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.core.hetero import (plan_placement, proportional_split,
                                     strategy_fits_cluster)
from repro_torch.core.schedule import SCHEDULE_NAMES
from repro_torch.launch.mesh import make_mesh, mesh_shape
from repro_torch.models.attention import decode_split
from repro_torch.optim.optimizer import sharded_global_norm
from repro_torch.tree import flatten, tree_map, unflatten

# ``repro_torch.core`` exports the ``pipeline`` scope under this module's
# name, as ``repro.core`` does: reach the engine module itself
pipe = importlib.import_module("repro_torch.core.pipeline")

ZERO_UNEVEN_SLICE = ("ZeRO with uneven batch shares comes with a later slice "
                     "of the port (ROADMAP.md queue A item 4)")
PIPELINE_SERVE_SLICE = ("serving inside a pipeline (pp > 1) comes with a later "
                        "slice of the port (ROADMAP.md queue A item 4)")
ZERO3_SERVE_SLICE = ("serving parameters sharded over data (zero=3) comes "
                     "with a later slice of the port (ROADMAP.md queue A "
                     "item 4)")
MULTIMODAL_SPLIT_SLICE = ("the {family} family split over model or under "
                          "ZeRO comes with a later slice of the port "
                          "(ROADMAP.md queue A item 7)")
#: the keys of ``Model.loss_fn``'s metrics, with the step's ``loss``: a
#: rank with no rows of the batch reports zeros under them
METRIC_KEYS = ("loss", "moe_lb", "moe_z", "nll", "tokens")


# ---------------------------------------------------------------------------
# strategy → mesh
# ---------------------------------------------------------------------------

def mesh_for_strategy(strat: StrategySpec, *, pods: int = 1,
                      device_type: str = "cuda", cluster_spec=None):
    """A mesh whose axes realise the strategy, in the reference's order
    (major→minor): pod, stage (when ``pp > 1``), data, model — so only DP
    crosses pods.

    ``cluster_spec`` (a :class:`~repro_torch.core.cost_model.ClusterSpec`)
    is validated against the strategy as the reference does: shards must
    tile each hardware group without straddling a group boundary
    (``ValueError`` otherwise).  The mesh shape itself is unaffected."""
    if cluster_spec is not None and not strategy_fits_cluster(
            strat, cluster_spec):
        raise ValueError(
            f"{strat.describe()} does not tile the device groups "
            f"{[(g.name, g.n_devices) for g in cluster_spec.groups]}")
    shape, names = [], []
    if pods > 1:
        shape.append(pods)
        names.append("pod")
    if strat.pp > 1:
        shape.append(strat.pp)
        names.append("stage")
    shape.append(strat.dp // pods if pods > 1 else strat.dp)
    names.append("data")
    shape.append(strat.model_parallel)   # tp and nested ep share the axis
    names.append("model")
    return make_mesh(tuple(shape), tuple(names), device_type=device_type)


# ---------------------------------------------------------------------------
# gradients of one batch
# ---------------------------------------------------------------------------

def loss_and_grads(model, params: dict, batch: dict, scale=None):
    """(loss, metrics, grads): the loss of one batch and its gradient with
    respect to every parameter leaf, as a tree shaped like ``params``
    (the gradient of ``scale``·loss where a scale is given)."""
    paths, leaves = flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss if scale is None else loss * scale,
                                leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(paths, list(grads))


def accumulate(model, params: dict, batch: dict, micro_batches: int = 1,
               scale=None):
    """Loss and grads summed sequentially over ``micro_batches`` equal
    slices of the batch and averaged (``train_step_fn``'s ``accumulate``;
    a batch they do not divide raises).  The sums and the division run in
    place in f32 (the same bits as adding into new tensors), so one
    gradient tree is held beside the micro-batch's."""
    M = micro_batches
    if M <= 1:
        return loss_and_grads(model, params, batch, scale)
    mb = pipe.check_micro_divides(batch["tokens"].shape[0], M)
    acc = None
    loss_sum, mets = 0.0, []
    for i in range(M):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics, g = loss_and_grads(model, params, micro, scale)
        g = flatten(g)[1]
        if acc is None:
            acc = [x.float() for x in g]
        else:
            for a, x in zip(acc, g):
                a.add_(x)
        del g
        loss_sum = loss_sum + loss
        mets.append(metrics)
    paths = flatten(params)[0]
    grads = unflatten(paths, [a.div_(M) for a in acc])
    metrics = {k: torch.stack([m[k] for m in mets]).mean(0)
               for k in mets[0]}
    return loss_sum / M, metrics, grads


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _token_count(batch: dict, M: int) -> torch.Tensor:
    """The ``tokens`` metric ``Model.loss_fn`` reports for ``batch`` over
    ``M`` micro-batches (their mean), from the batch alone."""
    tokens, lm = batch["tokens"], batch.get("loss_mask")
    B, S = tokens.shape
    mb = B // M
    counts = []
    for i in range(M):
        mask = torch.ones((mb, S - 1), dtype=torch.float32,
                          device=tokens.device)
        if lm is not None:
            mask = mask * lm[i * mb:(i + 1) * mb, 1:]
        counts.append(mask.sum())
    return torch.stack(counts).mean(0)


def _reduce_metrics(metrics: dict, group, sum_keys: tuple) -> dict:
    """Metrics averaged over ``group``, except ``sum_keys``, summed."""
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].float().reshape(()) for k in keys])
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return {k: v if k in sum_keys else v / n
            for k, v in zip(keys, vec.unbind())}


@dataclasses.dataclass
class ExecutionPlan:
    """A model, its mesh (``None``: one device, no collectives) and the
    strategy derived from it.  ``placement`` is the reference's: a
    :class:`~repro_torch.core.hetero.HeteroPlacement` on a mixed-hardware
    cluster, else ``None``.  On a mesh, ``rules`` and ``param_specs`` are
    the reference's (``None`` without a mesh or a model).
    ``compress_pod``: the plan trains with the compressed cross-pod
    reduction, so on a ``pod`` axis ZeRO shards over ``data`` alone
    (:attr:`fsdp_axes`)."""
    model: object
    mesh: object
    strategy: StrategySpec
    placement: object = None
    rules: object = None
    compress_pod: bool = False

    def __post_init__(self):
        if self.mesh is not None and self.rules is None:
            self.rules = sharding.rules_for_strategy(
                mesh_shape(self.mesh), self.strategy, self.mesh,
                fsdp_axes=self.fsdp_axes)
        self.param_specs = None
        if self.rules is not None and self.model is not None:
            self.param_specs = self._specs(self.model.axes(),
                                           self.model.param_shapes(),
                                           fsdp=self.strategy.zero >= 3)

    @property
    def pipelined(self) -> bool:
        return self.strategy.pp > 1

    @property
    def two_towers(self) -> bool:
        """Whether the model is an encoder–decoder, which pipelines over
        the two-tower engine."""
        return self.model is not None and self.model.stack is None

    @property
    def fsdp_axes(self) -> tuple:
        """The data axes ZeRO shards over: ``pod`` and ``data``, or
        ``data`` alone where the pods are replicas joined by the
        compressed reduction."""
        pods = (self.compress_pod and self.mesh is not None
                and "pod" in self.mesh.mesh_dim_names)
        return ("data",) if pods else ("pod", "data")

    def _specs(self, axes, shapes, *, fsdp: bool) -> dict:
        """The specs of a tree: the reference's ``staged_specs`` under a
        pipeline (its layers over ``stage``, nothing over the data axes;
        an encoder–decoder's tree replicated over the stages), else
        ``param_specs_tree`` with the ZeRO extension where ``fsdp``."""
        if self.pipelined and self.two_towers:
            return self.rules.param_specs_tree(axes, shapes, fsdp=False)
        if self.pipelined:
            return sharding.staged_specs(self.rules, axes, shapes)
        return self.rules.param_specs_tree(axes, shapes, fsdp=fsdp,
                                           fsdp_axes=self.fsdp_axes)

    @property
    def sharded(self) -> bool:
        """Whether ranks hold blocks of the model or its optimizer state
        (a model axis, or ZeRO), so steps run under :attr:`rules`."""
        return self.param_specs is not None and (
            self.strategy.model_parallel > 1 or self.strategy.zero >= 1)

    def _zero_blocks(self):
        """ZeRO-1/2 outside a pipeline: the specs of the blocks the
        optimizer updates, the parameters' rules with the ZeRO extension
        over the data axes (each parameter's spec with its slice's axes on
        one dim); else ``None``, the parameters' own blocks."""
        if not self.sharded or self.pipelined \
                or self.strategy.zero not in (1, 2):
            return None
        return self._specs(self.model.axes(), self.model.param_shapes(),
                           fsdp=True)

    def _slices(self):
        """ZeRO-1/2: each leaf's :class:`~repro_torch.core.sharding.Slice`
        beyond the parameter's own block (:meth:`_zero_blocks`); none
        inside a pipeline, whose state takes the parameters' layout."""
        blocks = self._zero_blocks()
        return None if blocks is None else sharding.zero_slices(
            self.param_specs, blocks, self.rules)

    def state_layout(self, optimizer) -> dict:
        """The optimizer state's specs, as the ranks hold it: the state's
        axes map applied to the specs of the blocks it updates (the
        parameters', under ZeRO-1/2 their slices', under a pipeline the
        staged specs).  AdamW's are the reference's ``opt_specs``;
        Adafactor's factored moments are the block's spec less the dim
        each averages (their means are all-reduced over it), which the
        checkpoint's gather and restore cut by."""
        blocks = self._zero_blocks()
        return optimizer.state_axes(
            self.param_specs if blocks is None else blocks)

    def shard(self, tree: dict, specs: dict) -> dict:
        """This rank's block of every leaf of a full ``tree``."""
        return tree_map(lambda x, s: sharding.shard_leaf(x, s, self.rules),
                        tree, specs)

    def _group(self, axis: str):
        if self.mesh is None or axis not in self.mesh.mesh_dim_names:
            return None
        return self.mesh.get_group(axis)

    def _index(self) -> int:
        """This rank's row block of the global batch: pod-major, then data,
        the order ``P(("pod", "data"))`` deals rows in the reference."""
        shape = mesh_shape(self.mesh)
        idx = 0
        for axis in ("pod", "data"):
            if axis in shape:
                idx = idx * shape[axis] + self.mesh.get_local_rank(axis)
        return idx

    # ---- init ----
    def _draw(self, seed: int) -> dict:
        """The whole model from ``seed``, the same on every rank: rank 0's
        are broadcast (a cuda generator draws per device)."""
        params = self.model.init(seed)
        if self.mesh is not None:
            for p in flatten(params)[1]:
                dist.broadcast(p, src=0)
        return params

    def init_params(self, seed: int) -> dict:
        """The model's parameters from ``seed``, the same on every rank
        (:meth:`_draw`).  A sharded plan keeps this rank's block of each
        leaf (never a draw per block, so the sharded start equals a slice
        of the unsharded one bit for bit)."""
        params = self._draw(seed)
        if self.sharded:
            params = self.shard(params, self.param_specs)
        return params

    def init_opt(self, optimizer, params: dict) -> dict:
        """``optimizer``'s state for this rank's ``params``: under ZeRO-1/2
        the state of this rank's slices."""
        slices = self._slices()
        if slices is None:
            return optimizer.init(params)
        return optimizer.init(tree_map(
            lambda p, c: p if c is None else c.narrow(p), params, slices))

    # ---- checkpoints of a sharded plan ----
    def _state_specs(self, state: dict, optimizer) -> dict:
        """The specs of a training state; the compressor's error carry
        ``err`` lies as the block it compresses, the parameter's (under
        ZeRO-1 the whole leaf, under ZeRO-3 the data shard)."""
        specs = {"params": self.param_specs,
                 "opt": self.state_layout(optimizer)}
        if "err" in state:
            specs["err"] = self.param_specs
        return specs

    def gather_state(self, state: dict, optimizer):
        """The whole training state from every rank's blocks, in the
        reference's layout: the tree on global rank 0, ``None`` on the
        others (collective; the checkpoint's ``gather`` hook)."""
        full = tree_map(lambda x, s: sharding.gather_leaf(x, s, self.rules),
                        state, self._state_specs(state, optimizer))
        return full if dist.get_rank() == 0 else None

    def restore_state(self, ckpt, optimizer, *, with_err: bool = False):
        """The latest committed checkpoint (the reference's layout), read
        whole on every rank into host memory and cut into this rank's
        blocks on the model's device: ``(step, state, extra)``, or
        ``None`` when there is none."""
        from repro_torch.optim import grad_compress

        shapes = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype),
                          self.model.param_shapes())
        target = {"params": shapes, "opt": optimizer.init(shapes)}
        if with_err:
            target["err"] = grad_compress.init_error_tree(shapes)
        out = ckpt.restore_latest(target)
        if out is None:
            return None
        step, tree, extra = out
        tree = tree_map(
            lambda x, s: sharding.shard_leaf(x, s, self.rules).to(
                self.model.device),
            tree, self._state_specs(tree, optimizer))
        return step, tree, extra

    def init_pipeline_params(self, seed: int, *, stage_layers=None) -> dict:
        """This rank's stage of the model from ``seed``: every rank draws
        the whole model (:meth:`_draw`), then keeps its rows of ``blocks``
        and, under the staged specs, its block of each leaf over
        ``model`` (never a draw per stage or block, so the pipelined start
        equals a slice of the unpipelined, unsharded one bit for bit).
        An encoder–decoder keeps the whole tree (stage-replicated)."""
        if self.two_towers:
            return self._draw(seed)
        sl = stage_layers or self.stage_layers()
        rows = pipe.stage_state(self._draw(seed),
                                self.mesh.get_local_rank("stage"), sl)
        return self.shard(rows, sharding.within_stage(self.param_specs))

    def _pipeline_state_specs(self, optimizer) -> dict:
        """The staged specs of a pipelined run's ``{"params", "opt"}``."""
        return {"params": self.param_specs,
                "opt": self.state_layout(optimizer)}

    def gather_pipeline_state(self, state: dict, optimizer, stage_layers):
        """A pipelined run's whole state in the reference's padded layout
        on global rank 0, ``None`` on the others (collective; the
        checkpoint's ``gather`` hook): :func:`~repro_torch.core.pipeline.
        gather_stages`."""
        return pipe.gather_stages(
            state, self._pipeline_state_specs(optimizer), self.rules,
            stage_layers)

    def restore_pipeline_state(self, ckpt, optimizer, stage_layers):
        """The latest pipelined checkpoint cut into this rank's stage rows
        and model blocks: :func:`~repro_torch.core.pipeline.
        restore_stage_state`."""
        return pipe.restore_stage_state(
            ckpt, self.model, optimizer,
            self._pipeline_state_specs(optimizer), self.rules, stage_layers)

    # ---- data ----
    def replica_rows(self) -> tuple | None:
        """Rows of each data replica, pod-major then data, under the
        placement's uneven batch shares; ``None`` where the batch splits
        evenly over ``pod × data``.

        Shares apply only when ``pp == 1`` and the placement holds one
        share per device group, for more than one group (under ``pp > 1``
        its one share is the planning batch, and rows split evenly).
        Group *g* owns ``n_g / model_parallel`` consecutive replicas in
        declaration order (the order ``strategy_fits_cluster`` tiles); its
        share is dealt to them by ``proportional_split`` over equal
        weights, the reference's largest-remainder helper, so (7, 1) over
        4 + 4 replicas gives (2, 2, 2, 1, 1, 0, 0, 0).  A replica may get
        no rows."""
        pl = self.placement
        if pl is None or self.strategy.pp != 1 or len(pl.spec.groups) < 2 \
                or len(pl.batch_shares) != len(pl.spec.groups):
            return None
        mp = self.strategy.model_parallel
        rows = []
        for g, share in zip(pl.spec.groups, pl.batch_shares):
            rows += proportional_split(share, [1.0] * (g.n_devices // mp))
        if len(rows) != self.strategy.dp:
            raise ValueError(f"the placement deals {len(rows)} replicas, the "
                             f"strategy has dp={self.strategy.dp}")
        return tuple(rows)

    def batch_slice(self, batch: dict) -> dict:
        """This rank's rows of the global batch, dealt over ``pod`` and
        ``data`` only: the stages of one data replica take the same rows.

        The placement's batch shares feed the loader here (the reference
        says only that ``HeteroPlacement.batch_slices()`` "feeds the data
        loader"; none of its code reads it): each replica takes its
        :meth:`replica_rows` in order, so the rows follow
        ``batch_slices()``, and a replica may take none.  Shares that do
        not sum to the global batch raise ``ValueError`` (never
        rescaled).  Without shares, a batch that ``pod × data`` does not
        divide raises ``ValueError``."""
        if self.mesh is None:
            return batch
        B = batch["tokens"].shape[0]
        rows = self.replica_rows()
        if rows is not None:
            if sum(rows) != B:
                raise ValueError(
                    f"the placement's batch shares "
                    f"{tuple(self.placement.batch_shares)} sum to "
                    f"{sum(rows)}, the global batch is {B}")
            i = self._index()
            lo = sum(rows[:i])
            return {k: v[lo:lo + rows[i]] for k, v in batch.items()}
        dp = self.strategy.dp
        if B % dp:
            raise ValueError(f"global batch {B} does not divide over "
                             f"pod x data = {dp} replicas")
        rows = B // dp
        lo = self._index() * rows
        return {k: v[lo:lo + rows] for k, v in batch.items()}

    # ---- training ----
    def train_step_fn(self, optimizer, *, micro_batches: int | None = None,
                      compress_pod: bool = False) -> Callable:
        """``(params, opt_state, batch, step) → (params, opt_state,
        metrics)``, or with ``compress_pod`` (and a ``pod`` axis)
        ``(params, opt_state, batch, step, err) → (params, opt_state,
        metrics, err)``, ``err`` in the parameters' layout.  ``batch`` is
        this rank's slice.  The optimizer
        and the compressor update their state in place.  Metrics (with
        ``loss``) are the reference's: means over the global batch, the
        token count summed over it; with ``compress_pod`` the mean over
        pods of each pod's (its ``pmean``), so the token count is a pod's.

        Each rank's loss is the mean over its own token count ``n_i``, so
        with even rows and no ``loss_mask`` the gradients are averaged
        (``mean_over``).  Otherwise (the placement's uneven shares, or a
        ``loss_mask``) the step takes the token-weighted mean Σ nᵢ·gᵢ / Σ
        nᵢ, the reference's one masked mean over the global batch: the
        scalar ``n_i`` is summed over the reduction group, each rank's
        gradients scaled by ``n_i / N`` and summed, and every metric but
        ``tokens`` (summed) weighted alike.  The group is ``pod × data``;
        with ``compress_pod`` it is the pod's ``data``, and the compressed
        mean over pods follows as before, unweighted like the reference's
        ``pmean``, so uneven shares with ``compress_pod`` raise
        ``ValueError``.  A rank with no rows runs no forward: it adds zero
        gradients and ``n_i = 0`` and joins every collective in order.

        ZeRO beside ``compress_pod``: ZeRO-1 compresses the parameter's
        block of each gradient (the whole leaf but for a model split) and
        its optimizer reads its slice of the result; ZeRO-3 compresses the
        data shard its reduce-scatter left.  ZeRO-3 needs the plan
        compiled with ``compress_pod`` (its parameters sharded inside the
        pod), else ``ValueError``.

        A model with experts (the moe family, the hybrid's odd blocks)
        balances them over the global batch, as the reference's GSPMD
        step does: the step runs under the plan's rules,
        and each block takes its routing statistics' means over the data
        axes (over the pod's ``data`` with ``compress_pod``, whose
        reference step balances each pod) before the aux losses.  Under
        ``micro_batches`` a micro-batch is each rank's own slice, so the
        balance runs over the union of the ranks' i-th slices.  Uneven
        batch shares and a ``loss_mask`` over data replicas raise
        ``ValueError`` for it: the all-reduce needs every replica with an
        equal share, and the step's token weights would weigh the unmasked
        balance by masked counts."""
        model = self.model
        M = micro_batches or self.strategy.micro_batches or 1
        data_g, pod_g = self._group("data"), self._group("pod")
        meshed = self.mesh is not None
        compress = compress_pod and pod_g is not None
        rows = self.replica_rows() if meshed else None
        uneven = rows is not None and len(set(rows)) > 1
        if uneven and compress:
            raise ValueError(
                f"uneven batch shares {rows} with compress_pod: the "
                f"compressed cross-pod reduction is an unweighted mean over "
                f"pods (the reference's pmean), which would weight the "
                f"pods' tokens unevenly")
        zero = self.strategy.zero if self.sharded else 0
        if compress and zero >= 3 and not self.compress_pod:
            raise ValueError(
                "zero=3 with compress_pod: compile the plan with "
                "compress_pod=True, so that the parameters are sharded over "
                "data inside each pod and the pods stay replicas")
        experts = model.cfg.has_experts
        if experts and uneven:
            raise ValueError(
                f"uneven batch shares {rows} for a model with experts: the "
                f"experts' balance over the global batch needs every "
                f"replica in its all-reduce with an equal share of the rows "
                f"(a replica with no rows runs no forward)")
        for r in set(rows or ()) - {0}:
            pipe.check_micro_divides(r, M)
        # the step runs under the plan's rules on a mesh: they split the
        # model, and deal the batch over the data axes that the experts'
        # balance is taken over; with compress_pod over the pod's data
        # only, as the reference's step, manual over pod, balances a pod
        rules = self.rules if meshed else None
        if compress:
            rules = dataclasses.replace(
                rules, rules=dict(rules.rules, batch="data"))
        with sharding.use_rules(rules):
            balanced = experts and bool(sharding.batch_splits())
        specs = self.param_specs
        slices = self._slices()
        weight_axes = [a for a in (("data",) if compress
                                   else ("data", "pod"))
                       if self._group(a) is not None]
        # ZeRO-3: the axes each leaf's gradient was already summed over by
        # the backward's reduce-scatter (its gather at use)
        summed = ([{a for p in spec for a in sharding._axes(p)}
                   for spec in flatten(specs)[1]] if zero >= 3 else None)

        def reduce_over(leaves: list, axis: str, *, mean: bool) -> None:
            """Each leaf summed over ``axis`` (unless the backward summed
            it there already), then divided by its size for a mean."""
            group = self._group(axis)
            n = dist.get_world_size(group)
            for i, t in enumerate(leaves):
                if summed is None or axis not in summed[i]:
                    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
                if mean:
                    t /= n

        def weight_of(n):
            """(n_i / N): this rank's share of the tokens over
            ``weight_axes``."""
            N = n.clone()
            for a in weight_axes:
                dist.all_reduce(N, op=dist.ReduceOp.SUM,
                                group=self._group(a))
            return n / N.clamp_min(1.0)

        def weighted(g, metrics, w=None):
            """The token-weighted sums over ``weight_axes``; ``w`` where
            the gradient was taken of the weighted loss already."""
            prescaled = w is not None
            if w is None:
                w = weight_of(metrics["tokens"].float().reshape(()))
            keys = sorted(metrics)
            vec = torch.stack([metrics[k].float().reshape(()) *
                               (1.0 if k == "tokens" else w) for k in keys])
            leaves = flatten(g)[1]
            if not prescaled:
                for t in leaves:
                    t.mul_(w)
            for a in weight_axes:
                reduce_over(leaves, a, mean=False)
                dist.all_reduce(vec, op=dist.ReduceOp.SUM,
                                group=self._group(a))
            return dict(zip(keys, vec.unbind()))

        def grads_and_metrics(params, batch):
            w = None
            if batch["tokens"].shape[0] == 0:
                g = unflatten(flatten(params)[0],
                              [torch.zeros_like(p)
                               for p in flatten(params)[1]])
                dev = batch["tokens"].device
                metrics = {k: torch.zeros((), device=dev)
                           for k in METRIC_KEYS}
            else:
                if balanced and "loss_mask" in batch:
                    raise ValueError(
                        "a loss_mask for the moe family (or a hybrid's "
                        "experts) over data replicas: the step weights "
                        "each replica by its masked tokens, while the "
                        "experts' balance is the global batch's, "
                        "unmasked, as the reference's")
                if summed is not None and "loss_mask" in batch:
                    # the reduce-scatter sums gradients as the backward
                    # makes them: weight the loss before it
                    w = weight_of(_token_count(batch, M))
                with sharding.use_rules(rules):
                    loss, metrics, g = accumulate(model, params, batch, M,
                                                  scale=w)
                metrics = dict(metrics, loss=loss)
            if not meshed:
                return g, metrics
            if uneven or "loss_mask" in batch:
                metrics = weighted(g, metrics, w)
                if compress:
                    metrics = _reduce_metrics(metrics, pod_g, ())
                return g, metrics
            if data_g is not None:
                reduce_over(flatten(g)[1], "data", mean=True)
                metrics = _reduce_metrics(metrics, data_g, ("tokens",))
            if pod_g is not None:
                if not compress:
                    reduce_over(flatten(g)[1], "pod", mean=True)
                metrics = _reduce_metrics(
                    metrics, pod_g, () if compress else ("tokens",))
            return g, metrics

        def update(g, opt_state, params, step):
            if not self.sharded:
                return optimizer.apply(g, opt_state, params, step)
            return optimizer.apply(
                g, opt_state, params, step,
                grad_norm=sharded_global_norm(g, specs, self.rules),
                slices=slices, specs=specs, rules=self.rules,
                shapes=self.model.param_shapes())

        if compress:
            from repro_torch.optim import grad_compress

            # per leaf, the groups its block is cut over inside the pod
            split_groups = None if specs is None else tree_map(
                lambda spec: tuple(
                    self._group(a) for e in spec for a in sharding._axes(e)
                    if self.rules.shape[a] > 1), specs)

            def step_fn(params, opt_state, batch, step, comp_err):
                g, metrics = grads_and_metrics(params, batch)
                # cross-pod reduction with int8 error feedback (explicit,
                # as in the reference; the in-pod mean is already taken):
                # each rank compresses its block against its leaf's scale
                g, comp_err = grad_compress.compressed_psum_tree(
                    g, pod_g, comp_err, mean=True, split_groups=split_groups)
                params, opt_state = update(g, opt_state, params, step)
                return params, opt_state, metrics, comp_err

            return step_fn

        def step_fn(params, opt_state, batch, step):
            g, metrics = grads_and_metrics(params, batch)
            params, opt_state = update(g, opt_state, params, step)
            return params, opt_state, metrics

        return step_fn

    # ---- pipelined training (pp > 1) ----
    def stage_layers(self) -> tuple:
        """Per-stage layer-repeat counts: the placement's latency-equalizing
        ``layer_alloc`` when it holds one count per stage, else the even
        split (the reference's ``ExecutionPlan.stage_layers``).  An
        encoder–decoder's are its towers' layer counts, the fixed cut."""
        if self.two_towers:
            ecfg = self.model.ecfg
            return (ecfg.n_enc_layers, ecfg.n_dec_layers)
        pl = self.placement
        if pl is not None and len(pl.layer_alloc) == self.strategy.pp:
            return pipe.stage_layers_from_alloc(self.model.stack,
                                                pl.layer_alloc)
        return pipe.even_stage_layers(self.model.stack.n_rep,
                                      self.strategy.pp)

    def pipeline_train_step_fn(self, optimizer, *,
                               micro_batches: int | None = None,
                               schedule: str | None = None,
                               stage_layers=None) -> Callable:
        """``(params, opt_state, tokens, step) → (params, opt_state,
        metrics)`` through the multi-rank pipeline engine
        (:func:`~repro_torch.core.pipeline.make_pipeline_train_step`) on
        this rank's ``stage`` group under the plan's rules (split over
        ``model``), averaged over ``data`` and ``pod``.  ``params`` and
        ``opt_state`` are this rank's stage (:meth:`init_pipeline_params`);
        ``tokens`` its data replica's rows (:meth:`batch_slice`).
        Micro-batches and schedule default to the strategy's, stage layers
        to :meth:`stage_layers`.  Adafactor takes its means over the whole
        leaf across the stages and the model blocks
        (:mod:`repro_torch.optim.optimizer`)."""
        axes = tuple(self.mesh.mesh_dim_names) if self.mesh is not None \
            else ()
        if self.strategy.pp <= 1 or "stage" not in axes:
            raise ValueError(
                f"pipeline step needs pp > 1 and a 'stage' mesh axis; "
                f"strategy is {self.strategy.describe()}, mesh axes {axes}")
        if self.two_towers:
            # the two-tower engine: ``(params, opt_state, frames, tokens,
            # step)``; stage layers and the schedule do not apply
            return pipe.make_encdec_pipeline_train_step(
                self.model, self.rules, optimizer,
                micro_batches=micro_batches or self.strategy.micro_batches
                or 1)
        return pipe.make_pipeline_train_step(
            self.model, self.rules, optimizer,
            micro_batches=micro_batches or self.strategy.micro_batches or 1,
            stage_layers=stage_layers or self.stage_layers(),
            schedule=schedule or self.strategy.schedule)

    def split_line(self, stage_layers=None) -> str:
        """How the plan lays the model out, for the drivers' ``[plan]``
        line: its mesh, what the model and data axes split, and a
        pipeline's stage layers."""
        st = self.strategy
        shape = mesh_shape(self.mesh) if self.mesh is not None else None
        parts = [f"mesh {shape}"]
        if st.model_parallel > 1:
            family = self.model.cfg.family if self.model is not None \
                else "dense"
            experts = "whole experts"
            if family in ("moe", "hybrid") and self.rules.spec_for(
                    ("experts",), (self.model.cfg.n_experts,)) == (None,):
                experts = "experts' d_ff columns"
            what = {"ssm": "SSD heads",
                    "moe": f"heads, {experts}, MLP columns",
                    "hybrid": f"heads, SSD heads, {experts}, MLP columns"
                    }.get(family, "heads, MLP columns")
            parts.append(f"split×{st.model_parallel} over model ({what}"
                         f"{', vocab' if st.vocab_split else ''})")
        if st.pp > 1:
            parts.append(f"pipeline×{st.pp} over stage, stage layers "
                         f"{tuple(stage_layers or self.stage_layers())}")
        elif st.zero:
            what = ("optimizer state" if st.zero < 3
                    else "parameters, gradients and optimizer state")
            parts.append(f"zero={st.zero}: {what} over data")
        return "; ".join(parts)

    # ---- serving ----
    def _spec_tree(self, axes: dict, shapes: dict) -> dict:
        """Each leaf's spec by the rules (all ``None`` without rules):
        ``rules.spec_for(names, shape)``, the reference's."""
        rules = self.rules or sharding.ShardingRules(shape={})
        return tree_map(lambda names, sd: rules.spec_for(names, sd[0]),
                        axes, shapes)

    def state_specs(self, batch: int, cache_len: int) -> dict:
        """The dense decode state's specs (the reference's): slots over
        the data axes; a KV cache's sequence over ``model`` where the
        cache length divides it, else its kv heads."""
        return self._spec_tree(self.model.state_axes(),
                               self.model.decode_state_shapes(batch,
                                                              cache_len))

    def paged_state_specs(self, batch: int, n_pages: int, page_size: int,
                          max_pages: int) -> dict:
        """The paged decode state's specs (the reference's): the pools'
        kv heads over ``model``, pages and rows whole; block-table rows
        and positions over the data axes."""
        return self._spec_tree(self.model.paged_state_axes(),
                               self.model.paged_state_shapes(
                                   batch, n_pages, page_size, max_pages))

    def local_zeros(self, shapes: dict, specs: dict) -> dict:
        """Zeroed blocks of a state on the model's device: each leaf of
        ``shapes`` (``(shape, dtype)`` pairs) cut as its spec says."""
        size = (self.rules.axis_size if self.rules is not None
                else lambda entry: 1)
        return tree_map(
            lambda sd, spec: torch.zeros(
                [n // size(e) for n, e in zip(sd[0], spec)], dtype=sd[1],
                device=self.model.device), shapes, specs)

    def slot_block(self, batch: int) -> tuple:
        """This rank's decode slots ``[lo, hi)`` of ``batch``: split over
        the data axes, pod-major (the state specs' ``batch`` dim); a batch
        they do not divide raises ``ValueError``."""
        if self.mesh is None:
            return 0, batch
        shape = mesh_shape(self.mesh)
        dp = shape.get("pod", 1) * shape.get("data", 1)
        if batch % dp:
            raise ValueError(f"{batch} decode slots do not divide over pod x "
                             f"data = {dp} replicas")
        n = batch // dp
        return self._index() * n, (self._index() + 1) * n

    def gather_slots(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's slots of ``t`` (dim 0) in slot order: gathered over
        the data axes, minor first.  Over gloo the gather runs on the host
        (a card's tensor is copied there once and comes back on the
        host)."""
        for axis in ("data", "pod"):
            group = self._group(axis)
            if group is None:
                continue
            if sharding._via_host(group, t):
                t = t.cpu()
            t = sharding.gather_cat(t, group, 0)
        return t

    def _serving_rules(self):
        """The rules the serving functions run under (``None`` without a
        mesh), after the refusals of later slices."""
        if self.strategy.pp > 1:
            raise NotImplementedError(PIPELINE_SERVE_SLICE)
        if self.sharded and self.strategy.zero >= 3:
            raise NotImplementedError(ZERO3_SERVE_SLICE)
        return self.rules if self.mesh is not None else None

    def _serving(self, fn: Callable) -> Callable:
        """``fn(*args) → (logits, state)`` run under the plan's rules,
        entered on every call (so on whatever thread calls it) without
        autograd, its logits (this rank's vocab columns) gathered whole
        over ``model``."""
        rules = self._serving_rules()
        vp = self.model.cfg.padded_vocab

        def run(*args, **kw):
            with sharding.use_rules(rules), torch.no_grad():
                logits, state = fn(*args, **kw)
                split = sharding.split_of("vocab", vp)
                if split is not None:
                    logits = sharding.gather_cat(logits, split.group, -1)
            return logits, state

        return run

    def _decoding(self, batch: int) -> None:
        """The decode steps' refusals: slots the data axes do not divide,
        and a layout decode has no split for (``decode_split``)."""
        self._serving_rules()
        self.slot_block(batch)
        if self.two_towers or any(b.mixer == "attn"
                                  for b in self.model.stack.pattern):
            with sharding.use_rules(self.rules):
                decode_split(self.model.cfg.attn_cfg())

    def prefill_fn(self, gen_budget: int = 64) -> Callable:
        """``(params, batch, last_idx=None) → (logits (B, Vp), state)``:
        :meth:`Model.prefill` under the plan (the reference's
        ``jit_prefill``).  Every rank prefills the same batch, replicated
        over the data axes and split over ``model`` (the flash kernel on
        this rank's heads); the state is the split model's (this rank's
        kv heads)."""
        model = self.model
        return self._serving(lambda params, batch, last_idx=None:
                             model.prefill(params, batch, gen_budget,
                                           last_idx))

    def serve_step_fn(self, batch: int, cache_len: int) -> Callable:
        """``(params, tokens, state) → (logits (b, Vp), state)``:
        :meth:`Model.serve_step` under the plan (the reference's
        ``jit_serve_step``) on this rank's ``b`` slots of ``batch``
        (:meth:`slot_block`), the state its blocks by
        :meth:`state_specs` (``cache_len`` rows; where they split the
        sequence the step is told so), written in place."""
        self._decoding(batch)
        caches = self.state_specs(batch, cache_len)["cache"].values()
        seq_split = any(
            spec[2] is not None and self.rules.axis_size(spec[2]) > 1
            for leaves in caches for key, spec in leaves.items()
            if key in ("k", "v"))
        model = self.model
        return self._serving(lambda params, tokens, state: model.serve_step(
            params, tokens, state, seq_split))

    def serve_step_paged_fn(self, batch: int, n_pages: int, page_size: int,
                            max_pages: int) -> Callable:
        """``(params, tokens, state) → (logits (b, Vp), state)``:
        :meth:`Model.serve_step_paged` under the plan (the reference's
        ``jit_serve_step_paged``) on this rank's slots, its pools by
        :meth:`paged_state_specs` (this rank's kv heads of every page)."""
        self._decoding(batch)
        return self._serving(self.model.serve_step_paged)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def strategy_from_taskgraph(cluster) -> StrategySpec:
    """Derive the StrategySpec implied by recorded scope annotations
    (the Cases-1..5 path: scopes → IR → engine), as the reference does:
    dp = pod × data; a dense split takes the model axis as tp (and splits
    the vocab), an expert split as ep; a stage or pipeline scope takes the
    stage axis as pp, with the largest ``micro_batch`` recorded."""
    shape = mesh_shape(cluster.mesh)
    tg = cluster.taskgraph
    kinds = set()
    micro = 1
    dense_split = expert_split = False
    for sg in (tg.nodes if tg else []):
        for ann in sg.strategy:
            kinds.add(ann.kind)
            if ann.kind == "pipeline":
                micro = max(micro, ann.options.get("micro_batch", 1))
            if ann.kind == "split":
                if ann.options.get("experts"):
                    expert_split = True
                else:
                    dense_split = True
    dp = shape.get("pod", 1) * shape.get("data", 1)
    model_ax = shape.get("model", 1)
    tp = model_ax if dense_split else 1
    ep = model_ax if expert_split else 1
    pp = shape.get("stage", 1) if kinds & {"stage", "pipeline"} else 1
    return StrategySpec(dp=dp, tp=tp, pp=pp, ep=ep, micro_batches=micro,
                        vocab_split=dense_split)


def compile_plan(model, mesh, strategy: StrategySpec | None = None, *,
                 cluster_spec=None, workload_meta=None, placement=None,
                 overlap: float = 0.0,
                 compress_pod: bool = False) -> ExecutionPlan:
    """model + mesh (+ strategy) → :class:`ExecutionPlan`.  Without a
    strategy it is read off the mesh as the reference does: dp = pod ×
    data, tp = model, pp = stage.  ``mesh=None`` is one device.  A
    pipeline (``pp > 1``) runs ``gpipe`` or ``1f1b``; another schedule
    name raises ``ValueError``.

    ``cluster_spec`` + ``workload_meta``, as the reference's: on a
    mixed-hardware cluster the plan carries the balanced
    :class:`~repro_torch.core.hetero.HeteroPlacement`
    (:func:`~repro_torch.core.hetero.plan_placement`, priced at
    ``overlap``): its stage layers and batch shares are what the plan
    executes.  A caller's own ``placement`` passes through unchanged.  A
    homogeneous or absent spec, or no ``workload_meta``, leaves
    ``placement`` ``None``: the plan of the spec-less call.
    ``compress_pod``: the plan trains with the compressed cross-pod
    reduction (:class:`ExecutionPlan`)."""
    if strategy is None:
        shape = mesh_shape(mesh) if mesh is not None else {}
        strategy = StrategySpec(dp=shape.get("pod", 1) * shape.get("data", 1),
                                tp=shape.get("model", 1),
                                pp=shape.get("stage", 1))
    if strategy.schedule not in SCHEDULE_NAMES:
        raise ValueError(f"unknown schedule {strategy.schedule!r}; "
                         f"expected one of {SCHEDULE_NAMES}")
    if mesh is not None and mesh_shape(mesh).get("model", 1) \
            != strategy.model_parallel:
        raise ValueError(f"{strategy.describe()} needs a model axis of "
                         f"{strategy.model_parallel}; the mesh is "
                         f"{mesh_shape(mesh)}")
    if (placement is None and cluster_spec is not None
            and not cluster_spec.is_homogeneous and workload_meta is not None):
        placement = plan_placement(workload_meta, strategy, cluster_spec,
                                   overlap=overlap)
    family = model.cfg.family if model is not None else None
    if family in ("vlm", "encdec") and (strategy.model_parallel > 1
                                         or strategy.zero):
        raise NotImplementedError(
            MULTIMODAL_SPLIT_SLICE.format(family=family))
    plan = ExecutionPlan(model=model, mesh=mesh, strategy=strategy,
                         placement=placement, compress_pod=compress_pod)
    rows = plan.replica_rows()
    if strategy.zero and rows is not None and len(set(rows)) > 1:
        raise NotImplementedError(f"zero={strategy.zero} with the batch "
                                  f"shares {rows}: {ZERO_UNEVEN_SLICE}")
    return plan


def compile_plan_from_cluster(cluster, model,
                              workload_meta=None) -> ExecutionPlan:
    """Cases-1..5 path: the strategy inferred from the recorded TaskGraph
    (:func:`strategy_from_taskgraph`), compiled over the cluster's mesh.

    On a mixed-hardware cluster, pass the workload's ``WorkloadMeta``
    (e.g. ``graph_from_taskgraph(tg, batch).workload_meta()`` from
    :mod:`repro_torch.core.auto`) to get a balanced placement on the plan;
    without it — or with a homogeneous ``cluster.spec`` —
    ``plan.placement`` stays None."""
    strat = strategy_from_taskgraph(cluster)
    return compile_plan(model, cluster.mesh, strategy=strat,
                        cluster_spec=getattr(cluster, "spec", None),
                        workload_meta=workload_meta)
