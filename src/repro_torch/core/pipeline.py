"""Pipeline parallelism over a ``stage`` axis (paper Cases 3–4): the port
of ``repro/core/pipeline.py`` for decoder-LM stacks.

Whale pipelines graph partitions with host-side queues; the reference runs
a collective pipeline inside ``shard_map`` and moves activations with
``ppermute``.  The port holds one stage per rank and moves each
micro-batch's activation down the pipe, and its cotangent up, with
``torch.distributed`` point-to-point messages.  Two executors share one
schedule subsystem (:mod:`repro_torch.core.schedule`) and one stage
(:class:`_Stage`):

1. **The multi-rank engine** (:func:`make_pipeline_train_step`): each rank
   walks its own column of a :class:`~repro_torch.core.schedule.Schedule`
   tick table.  It differs from the reference, whose fused engine
   differentiates a forward scan: autodiff there always materialises
   GPipe's order, so its real peak activation memory is M in-flight
   micro-batches whatever the schedule (it warns to judge HBM feasibility
   at gpipe pricing).  The port runs the schedule it is given, so 1F1B
   holds min(M, S) micro-batches in flight, which is what
   :func:`~repro_torch.core.cost_model.step_cost` prices.
2. **The schedule interpreter** (:func:`schedule_grads`): every stage in
   one process, in exactly the table's order, with the activation buffer
   audited against :meth:`Schedule.per_stage_in_flight`.  It differs from
   the reference's, whose backward slot recomputes the stage from its
   saved input under ``jax.vjp``: here a forward slot keeps its autograd
   graph (bounded by the model's own remat) and the backward slot runs
   ``torch.autograd.backward`` on it, so remat full runs each layer's
   forward twice, not three times.  The losses and gradients are the same
   math.

Stages may hold **uneven** layer counts (``stage_layers``).  A rank holds
only its own rows of the stacked blocks, so no padding lives in memory;
the padded ``(S·Lmax, …)`` layout of :func:`pipeline_params` is the
checkpoint's, as in the reference (:func:`gather_stages`,
:func:`restore_stage_state`), so each package restores the other's
pipelined checkpoint.

Whale's nested hybrid (paper Case 4, ``split`` inside ``stage`` under
``replica``): where the reference runs its stages inside ``shard_map``,
manual over ``stage`` and GSPMD-auto over ``data`` and ``model``, the
engine runs each slot under the plan's sharding rules, so a stage is split
over ``model`` as the unpipelined model is (vocab-parallel embedding and
loss head, head-parallel attention, column-parallel MLP), and replicated
over ``data`` and ``pod``.  The layout is the reference's ``staged_specs``
(:func:`repro_torch.core.sharding.staged_specs`): nothing is sharded over
the data axes, whatever the ZeRO stage.  ``stage_only_specs`` (the
``shard_map`` in-specs) has no counterpart: a rank holds its own rows.
The dense, moe, ssm and hybrid families pipeline.  A stage runs its
blocks as the unpipelined training forward does, an SSD mixer through the
differentiable chunked scan; a tied table (mamba2's) lives on every stage
and its gradients, stage 0's lookup and the last stage's head, sum over
the stage group as the shared leaves' do.  A stage with experts (the moe
family, the hybrid's odd blocks) carries their leaves in its rows of
``blocks`` like any other (whole over ``model`` inside a stage, the
nesting ``pipeline{split[experts]}``) and adds their aux losses, ``aux /
M``, to the loss, reported as ``moe_lb`` and ``moe_z``.  A stage's rows
are whole pattern repeats (jamba's period of 8 blocks).

3. **The encoder–decoder two-tower engine**
   (:func:`make_encdec_pipeline_loss`,
   :func:`make_encdec_pipeline_train_step`): an encoder–decoder has no interchangeable layer stack; its cut is the
   edge between the towers (the M6 shape: a frontend stitched to a
   decoder).  Stage 0 runs the adapter and the encoder on each
   micro-batch's frames and sends the memory down; stage 1 embeds the
   targets, runs the decoder and the loss, and sends the memory's
   cotangent up.  M micro-batches drain in M + 1 ticks.  The parameters
   are replicated over the stages, and their gradients summed over them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import sharding
from repro_torch.core.schedule import BWD, FWD, Schedule, make_schedule
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizer import sharded_global_norm
from repro_torch.tree import flatten, tree_map, unflatten



# ---------------------------------------------------------------------------
# uneven stages: layer allocation + padded layout
# ---------------------------------------------------------------------------

def even_stage_layers(n_rep: int, n_stages: int) -> tuple:
    """The classic even split; raises unless ``n_stages`` divides."""
    if n_rep % n_stages:
        raise ValueError(
            f"n_rep={n_rep} not divisible by {n_stages} stages; pass an "
            f"explicit stage_layers vector (e.g. from the hetero planner's "
            f"HeteroPlacement.layer_alloc) for uneven pipelines")
    return (n_rep // n_stages,) * n_stages


def check_stage_layers(stage_layers, n_rep: int, n_stages: int) -> tuple:
    sl = tuple(int(x) for x in stage_layers)
    if len(sl) != n_stages:
        raise ValueError(f"stage_layers {sl} has {len(sl)} entries for "
                         f"{n_stages} stages")
    if any(x < 1 for x in sl):
        raise ValueError(f"every stage needs >= 1 layer repeat, got {sl}")
    if sum(sl) != n_rep:
        raise ValueError(f"stage_layers {sl} sums to {sum(sl)}, "
                         f"expected n_rep={n_rep}")
    return sl


def stage_layers_from_alloc(stack: tfm.StackCfg, layer_alloc) -> tuple:
    """HeteroPlacement.layer_alloc (model *layers* per stage, the planner's
    unit) → per-stage pattern-*repeat* counts (the executor's unit).

    A stage's layer share must be a whole number of pattern repeats (a
    repeat is the remat unit and cannot straddle a stage boundary)."""
    plen = len(stack.pattern)
    bad = [a for a in layer_alloc if a % plen]
    if bad:
        raise ValueError(
            f"stage layer allocation {tuple(layer_alloc)} is not a multiple "
            f"of the {plen}-block scan pattern; re-plan with pp dividing "
            f"n_rep or a pattern-aligned allocation")
    out = tuple(a // plen for a in layer_alloc)
    if sum(out) != stack.n_rep:
        raise ValueError(f"layer_alloc {tuple(layer_alloc)} covers "
                         f"{sum(out)} repeats, model has {stack.n_rep}")
    return out


def _pad_rows(p: torch.Tensor, sl: tuple) -> torch.Tensor:
    lmax = max(sl)
    out = p.new_zeros((len(sl) * lmax,) + tuple(p.shape[1:]))
    off = 0
    for s, n in enumerate(sl):
        out[s * lmax:s * lmax + n] = p[off:off + n]
        off += n
    return out


def _unpad_rows(p: torch.Tensor, sl: tuple) -> torch.Tensor:
    lmax = max(sl)
    return torch.cat([p[s * lmax:s * lmax + n] for s, n in enumerate(sl)])


def _even(sl: tuple) -> bool:
    return sl == (max(sl),) * len(sl)


def pad_stage_stack(blocks, stage_layers):
    """(n_rep, …) stacked block params → padded ``(S·Lmax, …)`` layout.

    Stage ``s`` owns rows ``[s·Lmax, s·Lmax + stage_layers[s])``; pad rows
    are zero.  An even split is the identity."""
    sl = tuple(stage_layers)
    if _even(sl):
        return blocks
    return tree_map(lambda p: _pad_rows(p, sl), blocks)


def unpad_stage_stack(blocks, stage_layers):
    """Inverse of :func:`pad_stage_stack` (drops the pad rows)."""
    sl = tuple(stage_layers)
    if _even(sl):
        return blocks
    return tree_map(lambda p: _unpad_rows(p, sl), blocks)


def pipeline_params(model, params: dict, stage_layers) -> dict:
    """Re-lay a standard param tree in the padded pipeline layout (the
    pipelined checkpoint's)."""
    out = dict(params)
    out["blocks"] = pad_stage_stack(params["blocks"], stage_layers)
    return out


def check_micro_divides(batch: int, micro_batches: int) -> int:
    """The ``B % M != 0`` guard: a truncated ``reshape(M, B // M, …)``
    would silently drop the trailing ``B % M`` sequences from the loss."""
    if micro_batches < 1:
        raise ValueError(f"micro_batches must be >= 1, got {micro_batches}")
    if batch % micro_batches:
        raise ValueError(
            f"global batch {batch} is not divisible by micro_batches="
            f"{micro_batches}; the truncated reshape would silently drop "
            f"{batch % micro_batches} sequence(s) from the loss — pick M "
            f"dividing B (or pad the batch)")
    return batch // micro_batches


def _map_blocks(fn, tree: dict, specs: dict | None = None) -> dict:
    """``fn`` over every leaf under a ``blocks`` key (parameters and the
    optimizer state's moments alike), or with ``specs`` (staged specs of
    ``tree``) over every leaf whose first dim is the stacked ``layers``
    one, over ``stage`` (an Adafactor ``vc`` of a stacked 2-D leaf, its
    mean over the layers, has none); the other leaves as they are."""
    paths, leaves = flatten(tree)
    staged = (["blocks" in p.split("/") for p in paths]
              if specs is None else
              [bool(sp) and sp[0] == "stage" for sp in flatten(specs)[1]])
    return unflatten(paths, [fn(x) if st else x
                             for st, x in zip(staged, leaves)])


def _rows(p: torch.Tensor, stage: int, stage_layers: tuple):
    """Stage ``stage``'s rows of a standard-layout stacked leaf (a view)."""
    off = sum(stage_layers[:stage])
    return p[off:off + stage_layers[stage]]


def stage_state(tree: dict, stage: int, stage_layers,
                specs: dict | None = None) -> dict:
    """Stage ``stage``'s rows of every ``blocks`` leaf (or with ``specs``,
    of every leaf they stage: :func:`_map_blocks`) of a standard-layout
    tree (copies, so the rest can be freed); the other leaves shared."""
    sl = tuple(stage_layers)
    return _map_blocks(lambda p: _rows(p, stage, sl).clone(), tree, specs)


# ---------------------------------------------------------------------------
# one stage's work
# ---------------------------------------------------------------------------

def _check_family(model, what: str) -> None:
    """A layer-stack engine refuses an encoder–decoder, as the
    reference's."""
    if model.stack is None:
        raise ValueError(
            f"{what} pipelines decoder-LM stacks; encoder–decoder models "
            f"pipeline over the two-tower cut instead — use "
            f"make_encdec_pipeline_loss / make_encdec_pipeline_train_step")


def _leaves(tree: dict) -> dict:
    """Autograd leaves over ``tree``'s storage (no copy): the step's
    gradients accumulate in their ``.grad``, never in the caller's."""
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def _grad(p: torch.Tensor) -> torch.Tensor:
    """The f32 gradient accumulated in a leaf of :func:`_leaves` (zeros
    where no slot reached it)."""
    if p.grad is None:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return p.grad.float()


def _grads(tree: dict) -> dict:
    return tree_map(_grad, tree)


def _rep_leaves(blocks: dict, n: int) -> tuple:
    """(each of ``n`` repeats' autograd leaves over its row of a stage's
    stacked ``blocks``, views with no copy; the stage's gradient, zeros
    shaped as ``blocks``).  Each leaf's ``.grad`` is its row of the
    gradient, so a backward adds a leaf's gradient into the stacked
    gradient in place as soon as it computes it.  Through one stacked
    leaf each repeat's view would come from an ``unbind`` made before the
    stage's forward, whose backward runs last: every gradient of a slot
    would be held to the slot's end (twice the stage's gradients at once
    from the second micro-batch on), then stacked into a copy."""
    grads = tree_map(torch.zeros_like, blocks)
    reps = []
    for r in range(n):
        leaves = _leaves(tree_map(lambda p, r=r: p[r], blocks))
        for leaf, g in zip(flatten(leaves)[1], flatten(grads)[1]):
            leaf.grad = g[r]
        reps.append(leaves)
    return reps, grads


def _shared_keys(model) -> list:
    return ["embed", "final_norm"] + ([] if model.cfg.tie_embeddings
                                      else ["head"])


class _Stage:
    """Stage ``s`` of ``S`` on its micro-batches.  A forward slot keeps its
    autograd graph until the backward slot runs it; ``graphs`` holds the
    live ones (the activation buffer) and ``peak`` its high-water mark.

    The loss is the reference's: Σ over micro-batches of ``(nll + z_loss)
    / n_total`` from the last stage plus ``aux / M`` from every stage;
    ``aux`` sums this stage's experts' ``lb_loss`` and ``z_loss`` over its
    micro-batches (detached; zero without experts).  Under rules that deal
    the batch over data axes, each micro-batch's experts balance over the
    data ranks of this stage (:func:`~repro_torch.models.moe.moe_block`).

    Under ``rules`` that split the model axis each slot runs split: stage
    0's embedding vocab-parallel, the stack head-parallel (``choose_layout``)
    with column-parallel MLPs, the last stage's loss head vocab-parallel,
    and ``blocks``/``shared`` are this rank's blocks of its rows.
    ``blocks`` are the stage's stacked rows: each repeat's slots run on
    leaves of its own over them, their gradients added into ``grads``
    (:func:`_rep_leaves`)."""

    def __init__(self, model, s: int, S: int, blocks: dict, shared: dict,
                 n_layers: int, M: int, mb_size: int, T: int, rules=None):
        self.model, self.s, self.last, self.M = model, s, s == S - 1, M
        self.reps, self.grads = _rep_leaves(blocks, n_layers)
        self.shared, self.rules = shared, rules
        self.stack = dataclasses.replace(model.stack, n_rep=n_layers)
        dev = model.device
        self.positions = torch.arange(T, device=dev)[None].expand(mb_size, T)
        self.mask = torch.ones((mb_size, T - 1), dtype=torch.float32,
                               device=dev)
        self.n_total = float(M * mb_size * (T - 1))     # all-ones loss mask
        self.graphs: dict = {}
        self.peak = 0
        self.aux = torch.zeros(2, dtype=torch.float32, device=dev)

    def forward(self, mb: int, x, tok: torch.Tensor):
        """→ (the output activation, detached; None on the last stage, the
        loss contribution, detached).  ``x`` is the received activation
        (ignored on stage 0, which embeds ``tok``)."""
        cfg = self.model.cfg
        x_in = None
        with sharding.use_rules(self.rules):
            if self.s == 0:
                x = layers.embed(self.shared["embed"], tok,
                                 cfg.padded_vocab).to(cfg.adtype)
            else:
                x = x_in = x.detach().requires_grad_(True)
            y, aux = tfm.apply_stack(self.reps, x, self.positions,
                                     self.stack)
            contrib = (aux["lb_loss"] + aux["z_loss"]) / self.M
            self.aux += torch.stack([aux["lb_loss"],
                                     aux["z_loss"]]).detach()
            if self.last:
                nll, zl, _ = self.model.head_loss(self.shared, y, tok,
                                                  self.mask)
                contrib = contrib + (nll + zl) / self.n_total
        self.graphs[mb] = (x_in, y, contrib)
        self.peak = max(self.peak, len(self.graphs))
        return (None if self.last else y.detach()), contrib.detach()

    def backward(self, mb: int, dy):
        """Run micro-batch ``mb``'s graph backward from the cotangent ``dy``
        of its output (None on the last stage, whose output is the loss),
        free it, and return the cotangent of its input (None on stage 0).

        It needs no rules: on the card the autograd engine runs the
        backward on its device thread, which sees none of this thread's,
        so each repeat's checkpointed recompute re-enters the rules it was
        built under (:func:`~repro_torch.models.transformer.apply_stack`)
        and the split's collectives carry their groups."""
        x_in, y, contrib = self.graphs.pop(mb)
        outs, cots = [], []
        if contrib.requires_grad:
            outs.append(contrib)
            cots.append(torch.ones_like(contrib))
        if not self.last:
            outs.append(y)
            cots.append(dy)
        torch.autograd.backward(outs, cots)
        return None if x_in is None else x_in.grad

    def block_grads(self) -> dict:
        """The stage's block gradients in f32, in its stacked layout."""
        return tree_map(lambda g: g.float(), self.grads)


def _schedule_for(schedule, n_stages: int, M: int) -> Schedule:
    if isinstance(schedule, Schedule):
        if schedule.n_micro != M:
            raise ValueError(f"schedule has n_micro={schedule.n_micro}, "
                             f"micro_batches={M}")
        return schedule
    return make_schedule(schedule, n_stages, M)


def _audit(peaks: list, sc: Schedule, stages=None) -> None:
    want = sc.per_stage_in_flight()
    if stages is not None:
        want = [want[s] for s in stages]
    if peaks != want:
        raise AssertionError(
            f"buffer audit: measured in-flight peaks {peaks} != schedule's "
            f"accounting {want}")


# ---------------------------------------------------------------------------
# schedule interpreter (order-faithful reference engine, one device)
# ---------------------------------------------------------------------------

def schedule_grads(model, params: dict, tokens, *, micro_batches: int,
                   schedule="1f1b", stage_layers=None,
                   n_stages: int | None = None):
    """Run one train step's forward and backward work in *exactly* the
    order of a :class:`~repro_torch.core.schedule.Schedule` tick table, all
    stages on the model's device.

    Stages are row slices of the standard ``(n_rep, …)`` param tree
    (uneven ``stage_layers`` welcome, no padding); activations and
    cotangents pass between them through a dictionary in place of the
    wire.  Every valid schedule yields the same loss and gradients; only
    the activation buffer's profile differs, and it is audited: the
    measured per-stage peaks must equal ``Schedule.per_stage_in_flight``
    (``AssertionError`` otherwise).

    Returns ``(loss, grads, stats)``: ``grads`` in the standard layout and
    in f32; ``stats`` with ``n_ticks``, ``bubble_fraction``,
    ``peak_in_flight``, ``per_stage_in_flight`` and ``stage_layers`` (the
    reference's), and for a model with experts ``moe_lb`` and ``moe_z``, the
    experts' aux losses summed over the stages and averaged over the
    micro-batches (the part of ``loss`` the reference's fused engine adds
    at ``psum(aux, "stage") / M``).
    """
    _check_family(model, "schedule_grads")
    M = micro_batches
    if n_stages is None:
        n_stages = len(stage_layers) if stage_layers is not None else 1
    sc = _schedule_for(schedule, n_stages, M)
    S = sc.n_stages
    n_rep = model.stack.n_rep
    if stage_layers is None:
        stage_layers = even_stage_layers(n_rep, S)
    stage_layers = check_stage_layers(stage_layers, n_rep, S)

    tokens = torch.as_tensor(tokens, device=model.device).long()
    B, T = tokens.shape
    mb_size = check_micro_divides(B, M)
    toks_mb = tokens.reshape(M, mb_size, T)
    shared = _leaves({k: params[k] for k in _shared_keys(model)})
    stages = [_Stage(model, s, S,
                     tree_map(lambda p, s=s: _rows(p, s, stage_layers),
                              params["blocks"]),
                     shared, stage_layers[s], M, mb_size, T)
              for s in range(S)]

    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    wire = {}                   # ("act" | "cot", stage, mb) -> tensor
    for _, s, mb, phase in sc.slots():
        if phase == FWD:
            x = wire.pop(("act", s, mb)) if s > 0 else None
            y, c = stages[s].forward(mb, x, toks_mb[mb])
            loss = loss + c
            if s < S - 1:
                wire[("act", s + 1, mb)] = y
        else:
            dy = wire.pop(("cot", s, mb)) if s < S - 1 else None
            dx = stages[s].backward(mb, dy)
            if s > 0:
                wire[("cot", s - 1, mb)] = dx
    assert not wire and not any(st.graphs for st in stages), \
        "schedule left dangling buffers"
    peaks = [st.peak for st in stages]
    _audit(peaks, sc)

    grads = _grads(shared)
    per_stage = []
    for st in stages:                   # the lists hold the only references
        paths, gs = flatten(st.grads)
        per_stage.append(gs)
        for leaf in (x for r in st.reps for x in flatten(r)[1]):
            leaf.grad = None
        st.grads = None
    blocks = []
    for i in range(len(paths)):         # a leaf at a time: the stages'
        blocks.append(torch.cat([ls[i].float() for ls in per_stage]))
        for ls in per_stage:            # gradients go as the whole comes
            ls[i] = None
    grads["blocks"] = unflatten(paths, blocks)
    stats = {"n_ticks": sc.n_ticks,
             "bubble_fraction": sc.bubble_fraction(),
             "peak_in_flight": max(peaks),
             "per_stage_in_flight": peaks,
             "stage_layers": stage_layers}
    if model.cfg.has_experts:
        aux = sum(st.aux for st in stages) / M
        stats.update(moe_lb=aux[0], moe_z=aux[1])
    return loss, grads, stats



# ---------------------------------------------------------------------------
# the multi-rank engine (one stage per rank, point-to-point messages)
# ---------------------------------------------------------------------------

def mean_over(tensors: list, group) -> None:
    """In place: each tensor ← its mean over ``group`` (sum, then divide
    by the group's size; a group of one still runs the collective)."""
    n = dist.get_world_size(group)
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t /= n


def wire_on_host(group, device: torch.device) -> bool:
    """Whether a message or gather over ``group`` must lie in host memory:
    gloo's point-to-point and gather carry host tensors only, so a stage
    on the card whose group is gloo's (two ranks sharing one card, which
    NCCL refuses) sends host copies and receives into host buffers."""
    return dist.get_backend(group) == "gloo" and device.type == "cuda"


class _Wire:
    """Messages between neighbouring stages of one stage group: NCCL
    carries device tensors; a gloo group on the card carries host copies
    (:func:`wire_on_host`), chosen by the group's backend."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.at = (torch.device("cpu") if wire_on_host(group, device)
                   else device)

    def exchange(self, sends: list, recvs: list, shape: tuple,
                 dtype) -> list:
        """Post the ``sends`` ((tensor, stage) pairs) and one receive of
        ``shape`` from each stage in ``recvs`` as one batch (its two
        directions progress together, so 1F1B's steady state, which sends
        down and up in one tick, cannot deadlock), wait for all, and
        return the received tensors on the device."""
        if not sends and not recvs:
            return []
        peer = lambda s: dist.get_global_rank(self.group, s)   # noqa: E731
        ops = [dist.P2POp(dist.isend, t.to(self.at).contiguous(), peer(s),
                          self.group) for t, s in sends]
        bufs = [torch.empty(shape, dtype=dtype, device=self.at)
                for _ in recvs]
        ops += [dist.P2POp(dist.irecv, b, peer(s), self.group)
                for b, s in zip(bufs, recvs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [b.to(self.device) for b in bufs]


def make_pipeline_train_step(model, rules, optimizer, *,
                             micro_batches: int, stage_layers, schedule):
    """→ ``(params, opt_state, tokens, step) → (params, opt_state,
    metrics)`` for this rank's stage: the counterpart of the reference's
    ``make_pipeline_train_step``, on the mesh of ``rules`` (a
    :class:`~repro_torch.core.sharding.ShardingRules` with a ``stage``
    axis, and ``pod``, ``data`` and ``model`` where the plan has them).

    ``params`` is this rank's tree under :func:`~repro_torch.core.sharding.
    staged_specs`: ``embed``, ``final_norm`` and the head (when untied)
    on every stage, and its own ``stage_layers[s]`` rows of ``blocks``
    (:func:`stage_state`), each leaf this rank's block over ``model``
    where the rules split it; ``opt_state`` is ``optimizer.init`` of it;
    ``tokens`` (B, T) this data replica's rows, the same on every rank of
    the replica.  The rank walks its column of the schedule's tick table.
    At each tick it runs its slot, then posts in one batch what it sends
    (its forward's output down, its backward's input cotangent up) and
    what its neighbours send it at that tick, so both sides of every
    message post it at the same tick.  A stage group joins the ranks of
    one ``pod``, ``data`` and ``model`` coordinate, so each model rank
    sends its copy of the (replicated) activation to its own peer: the
    wire carries it once per model rank.

    The gradients of the shared leaves are summed over the stage group (as
    the ``shard_map`` transpose sums them: stage 0's embedding, the last
    stage's norm and head, both ends of a tied embedding), each on its
    model block; then every gradient is averaged over ``data`` and over
    ``pod`` (the reference's mean over ``("pod", "data")``).  The optimizer
    updates this rank's tree in place, clipped by the whole model's global
    norm (:func:`~repro_torch.optim.optimizer.sharded_global_norm` over the
    staged specs: each element once, its squares summed in f64) and handed
    the staged specs and the whole leaves' shapes, over which Adafactor
    sums its means (a stacked leaf's rows over the stages, its blocks over
    ``model``).
    ``metrics``: ``loss``, and ``moe_lb`` and ``moe_z`` (the experts' aux
    losses, zero without experts), each summed over the stage group and
    averaged over the data axes, so every rank holds the same, the aux
    divided by M as the reference's fused engine divides them; and
    ``peak_in_flight``, this stage's audited buffer peak.  At ``dp > 1``
    each micro-batch's experts balance over the data ranks of a stage
    (the rules deal the batch over the data axes).  The schedule is the
    one given: 1F1B holds min(M, S) micro-batches in flight (see the
    module docstring)."""
    _check_family(model, "make_pipeline_train_step")
    stage_group = rules.group("stage")
    S = dist.get_world_size(stage_group)
    s = dist.get_rank(stage_group)
    M = micro_batches
    sc = _schedule_for(schedule, S, M)
    stage_layers = check_stage_layers(stage_layers, model.stack.n_rep, S)
    wire = _Wire(stage_group, model.device)
    keys = _shared_keys(model)
    cfg = model.cfg
    specs = sharding.staged_specs(rules, model.axes(), model.param_shapes())
    data_groups = [rules.group(a) for a in ("data", "pod")
                   if rules.shape.get(a, 1) > 1]
    # batch_isend_irecv on NCCL needs the group's first call to involve
    # every rank of it
    dist.barrier(group=stage_group)

    def step_fn(params, opt_state, tokens, step):
        tokens = torch.as_tensor(tokens, device=model.device).long()
        B, T = tokens.shape
        mb_size = check_micro_divides(B, M)
        toks_mb = tokens.reshape(M, mb_size, T)
        shared = _leaves({k: params[k] for k in keys})
        stage = _Stage(model, s, S, params["blocks"], shared,
                       stage_layers[s], M, mb_size, T, rules)
        shape = (mb_size, T, cfg.d_model)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        inbox = {}                      # ("act" | "cot", mb) -> tensor
        for row in sc.ticks:
            sends = []
            if row[s] is not None:
                mb, phase = row[s]
                if phase == FWD:
                    y, c = stage.forward(mb, inbox.pop(("act", mb), None),
                                         toks_mb[mb])
                    loss = loss + c
                    if s < S - 1:
                        sends.append((y, s + 1))
                else:
                    dx = stage.backward(mb, inbox.pop(("cot", mb), None))
                    if s > 0:
                        sends.append((dx, s - 1))
            recvs = []
            if s > 0 and row[s - 1] is not None and row[s - 1][1] == FWD:
                recvs.append((("act", row[s - 1][0]), s - 1))
            if s < S - 1 and row[s + 1] is not None \
                    and row[s + 1][1] == BWD:
                recvs.append((("cot", row[s + 1][0]), s + 1))
            got = wire.exchange(sends, [peer for _, peer in recvs], shape,
                                cfg.adtype)
            inbox.update(zip((key for key, _ in recvs), got))
        assert not inbox and not stage.graphs, \
            "schedule left dangling buffers"
        _audit([stage.peak], sc, [s])

        g_shared = _grads(shared)
        for g in flatten(g_shared)[1]:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=stage_group)
        grads = dict(g_shared, blocks=stage.block_grads())
        # the loss and the aux in one vector, summed over the stages
        vec = torch.cat([loss[None], stage.aux / M])
        dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=stage_group)
        for group in data_groups:
            mean_over(flatten(grads)[1] + [vec], group)
        params, opt_state = optimizer.apply(
            grads, opt_state, params, step,
            grad_norm=sharded_global_norm(grads, specs, rules),
            specs=specs, rules=rules, shapes=model.param_shapes())
        return params, opt_state, {"loss": vec[0], "moe_lb": vec[1],
                                   "moe_z": vec[2],
                                   "peak_in_flight": stage.peak}

    return step_fn


# ---------------------------------------------------------------------------
# the encoder–decoder two-tower engine
# ---------------------------------------------------------------------------

def _two_stages(model, rules) -> tuple:
    """(stage group, this rank's stage) of the two-tower engine, after its
    refusals: another family, and a stage axis other than 2."""
    if model.cfg.family != "encdec" or model.stack is not None:
        raise ValueError(
            f"make_encdec_pipeline_loss is the encoder–decoder engine; "
            f"family={model.cfg.family!r} pipelines via "
            f"make_pipeline_train_step")
    group = rules.group("stage")
    S = dist.get_world_size(group)
    if S != 2:
        raise ValueError(
            f"the encdec pipeline is a strict 2-stage engine (encoder tower "
            f"| decoder tower), got a stage axis of size {S}")
    return group, dist.get_rank(group)


def make_encdec_pipeline_loss(model, rules, *, micro_batches: int):
    """→ ``(params, frames, tokens) → (loss, grads)`` for this rank's
    stage of the two-tower pipeline (the reference's
    ``make_encdec_pipeline_loss`` with its gradient), on the mesh of
    ``rules`` (a ``stage`` axis of 2, and ``data``/``pod`` replicas).

    ``params`` is the whole tree, replicated over the stages (the
    reference's stage-replicated layout); ``frames`` (B, S_src, E) and
    ``tokens`` (B, T) this data replica's rows, the same on both stages.
    At tick t of M + 1 stage 0 runs the adapter and the encoder on
    micro-batch t's frames and sends the (mb, S_src, E) memory down;
    stage 1 embeds micro-batch t − 1's ``tokens[:, :-1]``, runs the
    decoder against the memory it received, takes ``(nll + z_loss) /
    n_total`` through the model's loss head (by device, as
    ``Model.loss_fn`` takes it; the reference's stage 1 takes its chunked
    head whatever ``xent_impl`` says) and runs its backward at once, then
    sends the memory's cotangent up; stage 0 runs the encoder's backward
    from it as it arrives.  Both directions of a tick are posted as one
    batch, so stage 0 holds at most two micro-batches' graphs.  The loss
    is Σ(nll + z_loss) / Σ n over the micro-batches (all-ones masks: n is
    known), and ``grads`` (f32, shaped as ``params``) are summed over the
    stages, each tower's leaves from its own stage, so every rank of the
    stage group returns the same ``loss`` and ``grads``."""
    group, s = _two_stages(model, rules)
    M = micro_batches
    cfg = model.cfg
    wire = _Wire(group, model.device)
    dist.barrier(group=group)

    def loss_and_grads(params, frames, tokens):
        frames = torch.as_tensor(frames, device=model.device)
        tokens = torch.as_tensor(tokens, device=model.device).long()
        B, S_src = frames.shape[:2]
        T = tokens.shape[1]
        mb = check_micro_divides(B, M)
        leaves = _leaves(params)
        n_total = float(M * mb * (T - 1))
        mask = torch.ones((mb, T - 1), dtype=torch.float32,
                          device=model.device)
        shape = (mb, S_src, cfg.d_model)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        graphs = {}                  # stage 0: mb -> its memory
        inbox = None                 # stage 1: the memory received
        with sharding.use_rules(rules):
            for t in range(M + 1):
                sends, recvs = [], []
                if s == 0:
                    if t < M:
                        mem = model.encode(leaves,
                                           frames[t * mb:(t + 1) * mb])
                        graphs[t] = mem
                        sends.append((mem.detach(), 1))
                    if t >= 1:
                        recvs.append(1)
                    got = wire.exchange(sends, recvs, shape, cfg.adtype)
                    if got:
                        torch.autograd.backward(graphs.pop(t - 1), got[0])
                else:
                    if t >= 1:
                        mem = inbox.detach().requires_grad_(True)
                        tok = tokens[(t - 1) * mb:t * mb]
                        x = model.decode_train(leaves, tok, mem)
                        nll, zl, _ = model.xent_sums(
                            leaves, model.final_norm(leaves, x), tok[:, 1:],
                            mask)
                        contrib = (nll + zl) / n_total
                        contrib.backward()
                        loss = loss + contrib.detach()
                        sends.append((mem.grad, 0))
                    if t < M:
                        recvs.append(0)
                    got = wire.exchange(sends, recvs, shape, cfg.adtype)
                    inbox = got[0] if got else None
        assert not graphs, "the two-tower engine left a dangling graph"
        grads = _grads(leaves)
        for g in flatten(grads)[1]:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        return loss, grads

    return loss_and_grads


def make_encdec_pipeline_train_step(model, rules, optimizer, *,
                                    micro_batches: int):
    """→ ``(params, opt_state, frames, tokens, step) → (params, opt_state,
    metrics)`` through the two-tower pipeline
    (:func:`make_encdec_pipeline_loss`): the gradients summed over the
    stages, then averaged over ``data`` and ``pod`` (as the loss), and
    the optimizer applied to the replicated tree in place.  ``metrics``:
    ``loss``, and ``moe_lb``/``moe_z`` zero (the family has no
    experts)."""
    loss_and_grads = make_encdec_pipeline_loss(model, rules,
                                               micro_batches=micro_batches)
    data_groups = [rules.group(a) for a in ("data", "pod")
                   if rules.shape.get(a, 1) > 1]

    def step_fn(params, opt_state, frames, tokens, step):
        loss, grads = loss_and_grads(params, frames, tokens)
        loss = loss.reshape(1)
        for group in data_groups:
            mean_over(flatten(grads)[1] + [loss], group)
        params, opt_state = optimizer.apply(grads, opt_state, params, step)
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        return params, opt_state, {"loss": loss[0], "moe_lb": zero,
                                   "moe_z": zero}

    return step_fn


# ---------------------------------------------------------------------------
# the pipelined checkpoint: the reference's padded layout
# ---------------------------------------------------------------------------

def gather_stages(tree: dict, specs: dict, rules, stage_layers):
    """This rank's training state gathered whole in :func:`pipeline_params`'
    padded ``(S·Lmax, …)`` layout (pad rows zero), the reference's
    pipelined checkpoint: each leaf first over ``model`` where ``specs``
    (staged specs of ``tree``) split it (:func:`~repro_torch.core.sharding.
    gather_leaf`), then each leaf its spec stages (its rows) over the
    stage group, a leaf at a time.  Collective over the mesh of
    ``rules``; global rank 0 gets the tree, the others ``None``."""
    group = rules.group("stage")
    sl = tuple(stage_layers)
    s = dist.get_rank(group)
    lmax = max(sl)
    first = dist.get_global_rank(group, 0)
    home = dist.get_rank() == 0

    def one(path, p, spec):
        p = sharding.gather_leaf(p, sharding.within_stage(spec), rules)
        if not (spec and spec[0] == "stage"):    # on every stage alike
            return p if home else None
        at = (torch.device("cpu") if wire_on_host(group, p.device)
              else p.device)
        mine = p.new_zeros((lmax,) + tuple(p.shape[1:]), device=at)
        mine[:sl[s]] = p.to(at)
        parts = ([torch.empty_like(mine) for _ in sl] if s == 0 else None)
        dist.gather(mine, parts, dst=first, group=group)
        return torch.cat(parts) if home else None

    paths, leaves = flatten(tree)
    out = [one(path, p, spec) for path, p, spec
           in zip(paths, leaves, flatten(specs)[1])]
    return unflatten(paths, out) if home else None


def restore_stage_state(ckpt, model, optimizer, specs: dict, rules,
                        stage_layers):
    """The latest committed checkpoint of a pipelined run (the padded
    layout), read on every rank into host memory: ``(step, {"params",
    "opt"} with this rank's stage rows, cut to its block of each leaf
    under ``specs`` (staged specs of the state), on the model's device,
    extra)``, or ``None`` when there is none."""
    shapes = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype),
                      model.param_shapes())
    params = pipeline_params(model, shapes, stage_layers)
    out = ckpt.restore_latest({"params": params,
                               "opt": optimizer.init(params)})
    if out is None:
        return None
    step, tree, extra = out
    sl = tuple(stage_layers)
    stage = rules.mesh.get_local_rank("stage")
    tree = stage_state(_map_blocks(lambda p: _unpad_rows(p, sl), tree,
                                   specs), stage, sl, specs)
    tree = tree_map(lambda p, spec: sharding.shard_leaf(
        p, spec, rules).to(model.device), tree, sharding.within_stage(specs))
    return step, tree, extra
