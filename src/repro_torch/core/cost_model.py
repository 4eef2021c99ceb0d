"""Meta-driven cost model (paper contribution #4): the port of
``repro/core/cost_model.py``.

"Different from the dry-run methodology, we use a meta-driven method to
measure the cost when we run the workload in different devices or
environments" — the cost of a candidate strategy is computed analytically
from tensor *metadata* (shapes/dtypes/FLOPs, from the config by
:func:`repro_torch.models.lm.model_graph`) plus a table of hardware
constants.  Nothing is allocated, compiled, or executed during strategy
search.

The cost of one training step under a strategy is a four-term sum (the
paper: "a combination of computation, communication, memory and other
metadata"):

  T_step = T_compute + T_comm + T_bubble        subject to  M_peak <= HBM

- ``T_compute``: FLOPs / (devices-sharing-the-work × peak FLOP/s), with a
  configurable MXU efficiency factor.  Training FLOPs = 3 × forward (fwd +
  2×bwd), + 1 extra forward when full remat is on.
- ``T_comm``: per-collective byte volumes × the bandwidth of the mesh axis
  they ride (fast vs slow link), using standard ring-collective cost
  formulas (all-reduce moves 2·(n−1)/n · bytes, all-gather/reduce-scatter
  (n−1)/n).
- ``T_bubble``: GPipe bubble fraction (S−1)/(M+S−1) applied to the pipeline's
  compute time.
- ``M_peak``: params + optimizer state + gradients (each divided by the axes
  that shard them) + activation working set (micro-batched, remat-aware).

Hardware tables: the reference's four, unchanged — TPU_V5E (the reference's
target), V100_16G/ETH35 (the paper's own cluster), and the P100/T4-class
parts of Whale's *heterogeneous* experiments (§5) — and H100_SXM, the card
the port runs on, from NVIDIA's data sheets.

Heterogeneous clusters (DESIGN.md §2–3): a :class:`ClusterSpec` holds one
:class:`DeviceGroup` per hardware kind (e.g. 8×V100 + 8×T4).  The four-term
cost is then evaluated *per group* — each group sees its own ``Hardware``
table and its share of the work — and the step time is the **max** over
groups (the slowest group dominates a synchronous step).  The balancing
mechanisms that choose those shares live in :mod:`repro_torch.core.hetero`.

Every expression keeps the reference's order and grouping, so the port's
numbers equal the reference's bit for bit (``tests/test_torch_planning.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

# ---------------------------------------------------------------------------
# hardware tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float            # FLOP/s per chip (bf16 / fp16 tensor)
    hbm_bw: float                # bytes/s per chip
    hbm_bytes: float             # device memory per chip
    link_bw: dict                # mesh-axis kind -> bytes/s per chip (uni-dir)
    mxu_eff: float = 0.55        # achievable fraction of peak on real matmuls
    # on-chip fast-memory budget visible to one kernel program (VMEM on
    # TPU; shared memory per SM on Hopper).  The reference's per-Hardware
    # kernel autotuner sizes its tiles against this, so a small-VMEM part
    # tiles smaller than a big one.
    vmem_bytes: float = 16 * 2**20
    axis_kind: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: {})

    def bw_for_axis(self, axis: str) -> float:
        kind = self.axis_kind.get(axis, "fast")
        return self.link_bw[kind]

    @property
    def flops_per_hbm_byte(self) -> float:
        """Roofline balance point: achievable FLOPs per HBM byte moved.
        A kernel tile must reuse each loaded byte at least this many times
        or the part runs bandwidth-bound — the autotuner grows tiles on
        high-ratio parts (T4, TPU) and shrinks them on low-ratio ones."""
        return self.peak_flops * self.mxu_eff / self.hbm_bw


# TPU v5e (assignment constants): 197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s ICI.
TPU_V5E = Hardware(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    hbm_bytes=16 * 2**30,
    vmem_bytes=16 * 2**20,                    # ~16 MiB VMEM per core
    link_bw={"fast": 50e9, "slow": 6.25e9},   # ICI link / DCN per chip
    axis_kind={"data": "fast", "model": "fast", "stage": "fast",
               "pod": "slow"},
)

# The paper's cluster: V100-16G with NVLink inside a server, 35 Gb/s Ethernet
# between servers (§3).  8 GPUs per server.
V100_PAPER = Hardware(
    name="v100_eth35",
    peak_flops=125e12,            # V100 tensor-core fp16 peak
    hbm_bw=900e9,
    hbm_bytes=16 * 2**30,
    vmem_bytes=8 * 2**20,                     # Volta SMEM+L2 working set
    link_bw={"fast": 150e9, "slow": 35e9 / 8 / 2},  # NVLink vs 35Gb shared by 8
    axis_kind={"data": "slow", "model": "fast", "stage": "fast"},
    mxu_eff=0.45,
)

# P100-16G: the previous-generation part Whale's heterogeneous cluster mixes
# with V100s (§5).  No tensor cores — fp16 peak ≈ 2× the 9.3 TFLOP/s fp32.
P100_16G = Hardware(
    name="p100_16g",
    peak_flops=18.7e12,
    hbm_bw=732e9,
    hbm_bytes=16 * 2**30,
    vmem_bytes=4 * 2**20,                     # Pascal: half Volta's on-chip
    link_bw={"fast": 80e9, "slow": 35e9 / 8 / 2},   # NVLink1 vs shared Eth
    axis_kind={"data": "slow", "model": "fast", "stage": "fast"},
    mxu_eff=0.40,
)

# T4-16G: the inference-class card that shows up in shared production pools —
# 65 TFLOP/s fp16 tensor, PCIe only (no NVLink).
T4_16G = Hardware(
    name="t4_16g",
    peak_flops=65e12,
    hbm_bw=300e9,
    hbm_bytes=16 * 2**30,
    vmem_bytes=6 * 2**20,                     # Turing SMEM+L2 working set
    link_bw={"fast": 16e9, "slow": 35e9 / 8 / 2},   # PCIe3 x16 vs shared Eth
    axis_kind={"data": "slow", "model": "fast", "stage": "fast"},
    mxu_eff=0.40,
)

# NVIDIA H100 SXM5 80GB, the card the port runs on.  Every rate is NVIDIA's
# published figure; writing measured rates back into a table is the
# profile-calibrated cost model's job (repro_torch.runtime.profiler).
H100_SXM = Hardware(
    name="h100",
    peak_flops=989e12,        # H100 SXM5 datasheet: dense bf16 tensor core
    hbm_bw=3.35e12,           # H100 SXM5 datasheet: HBM3 bandwidth
    hbm_bytes=80e9,           # H100 SXM5 datasheet: 80 GB HBM3
    vmem_bytes=228 * 2**10,   # NVIDIA Hopper tuning guide: shared memory
                              # per SM
    # H100 SXM5 datasheet: NVLink 4 at 900 GB/s both ways = 450 GB/s per
    # direction inside a server; between servers one 400 Gb/s NIC per GPU
    # (DGX H100 datasheet: 8 ConnectX-7 for 8 GPUs)
    link_bw={"fast": 450e9, "slow": 50e9},
    axis_kind={"data": "fast", "model": "fast", "stage": "fast",
               "pod": "slow"},
)


# ---------------------------------------------------------------------------
# heterogeneous cluster description (DESIGN.md §2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceGroup:
    """A homogeneous pool of devices inside a (possibly mixed) cluster."""
    name: str
    hw: Hardware
    n_devices: int

    @property
    def device_flops(self) -> float:
        """Effective FLOP/s of ONE device (peak × achievable efficiency)."""
        return self.hw.peak_flops * self.hw.mxu_eff

    @property
    def group_flops(self) -> float:
        """Effective FLOP/s of the whole group."""
        return self.device_flops * self.n_devices


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Per-device-group hardware tables for one physical cluster.

    A homogeneous cluster is the single-group special case; every
    heterogeneity-aware code path must reduce *exactly* to the homogeneous
    behaviour when ``is_homogeneous`` (regression-guarded by
    tests/test_heterogeneous.py).
    """
    groups: tuple

    def __post_init__(self):
        if not self.groups:
            raise ValueError("ClusterSpec needs at least one DeviceGroup")

    @classmethod
    def homogeneous(cls, hw: Hardware, n_devices: int,
                    name: str | None = None) -> "ClusterSpec":
        return cls(groups=(DeviceGroup(name or hw.name, hw, n_devices),))

    @property
    def n_devices(self) -> int:
        return sum(g.n_devices for g in self.groups)

    @property
    def is_homogeneous(self) -> bool:
        return len({g.hw.name for g in self.groups}) == 1

    @property
    def total_flops(self) -> float:
        return sum(g.group_flops for g in self.groups)

    def slowest(self) -> DeviceGroup:
        return min(self.groups, key=lambda g: g.device_flops)

    def min_bw(self, axis: str) -> float:
        """Bottleneck bandwidth for a collective spanning every group."""
        return min(g.hw.bw_for_axis(axis) for g in self.groups)


# ---------------------------------------------------------------------------
# collective cost formulas (ring algorithms)
# ---------------------------------------------------------------------------

def all_reduce_time(bytes_: float, n: int, bw: float) -> float:
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * bytes_ / bw


def all_gather_time(bytes_: float, n: int, bw: float) -> float:
    """bytes_ = full (gathered) tensor size."""
    if n <= 1:
        return 0.0
    return (n - 1) / n * bytes_ / bw


reduce_scatter_time = all_gather_time


def all_to_all_time(bytes_: float, n: int, bw: float) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) / n * bytes_ / bw / n


def p2p_time(bytes_: float, bw: float) -> float:
    return bytes_ / bw


# ---------------------------------------------------------------------------
# strategy description (what the auto-searcher enumerates)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """A point in Whale's strategy space for one TaskGraph.

    dp × max(tp, ep) × pp must equal the device count.  ``zero`` ∈
    {0, 1, 2, 3} (stage-3 = FSDP: params sharded over dp).  ``vocab_split``
    shards the classifier head over tp (the paper's Fig-4 technique).
    ``micro_batches`` only matters when pp > 1 (GPipe) or when used for
    grad accumulation.

    ``ep`` is the *nested* expert-parallel degree — the paper's
    ``replicate{split}`` hybrid (§4, the M6 recipe): DP outer, the MoE
    layers' ``experts`` dimension split over the model axis inner.  Expert
    weights shard ep-ways, the dense layers see the model axis as extra
    data parallelism, and dispatch/combine become all-to-all bridges
    (the reference's ``core/graph_opt.py``).  ``ep`` rides the same mesh
    axis as ``tp`` — when both exceed 1 they must be equal.
    """
    dp: int = 1
    tp: int = 1
    pp: int = 1
    micro_batches: int = 1
    zero: int = 0
    remat: bool = True
    vocab_split: bool = True
    opt_factored: bool = False     # adafactor-style O(N/d) second moments
    # pipeline schedule (repro_torch.core.schedule): "gpipe" holds all M
    # micro-batches of activations in flight; "1f1b" caps at min(M, pp)
    schedule: str = "gpipe"
    # nested expert parallelism: experts split over the model axis inside
    # each data-parallel replica (replica{split} — Whale §4 nesting)
    ep: int = 1

    def __post_init__(self):
        if self.ep < 1:
            raise ValueError(f"ep must be >= 1, got {self.ep}")
        if self.ep > 1 and self.tp > 1 and self.ep != self.tp:
            raise ValueError(
                f"nested ep={self.ep} and tp={self.tp} ride the same model "
                f"axis and must be equal when both exceed 1")

    @property
    def model_parallel(self) -> int:
        """Size of the model mesh axis: operator split and expert split
        share it (ep == tp when both are active)."""
        return max(self.tp, self.ep)

    @property
    def devices(self) -> int:
        return self.dp * self.model_parallel * self.pp

    def describe(self) -> str:
        bits = []
        inner = []
        if self.tp > 1:
            inner.append(f"split×{self.tp}")
        if self.ep > 1:
            inner.append(f"split[experts]×{self.ep}")
        if self.dp > 1:
            nest = "{" + " ".join(inner) + "}" if inner else ""
            bits.append(f"replica×{self.dp}"
                        + (f"+zero{self.zero}" if self.zero else "") + nest)
        else:
            bits.extend(inner)
        if self.pp > 1:
            sched = "" if self.schedule == "gpipe" else f",{self.schedule}"
            bits.append(f"pipeline×{self.pp}(µb={self.micro_batches}{sched})")
        if self.opt_factored:
            bits.append("adafactor")
        if not bits:
            bits.append("single-device")
        return " ".join(bits)


@dataclasses.dataclass(frozen=True)
class WorkloadMeta:
    """Per-step metadata of one model, extracted from the Whale IR / config.

    Everything here is derivable with eval_shape — no execution.  FLOPs are
    *forward* FLOPs for the global batch; the cost model applies the 3×
    training multiplier itself.
    """
    name: str
    fwd_flops: float               # forward FLOPs / step (global batch)
    param_bytes: float             # total parameter bytes
    # bytes of params that a `split`/tp strategy can shard (e.g. the big FC);
    # the rest is replicated under pure TP.
    tp_shardable_param_bytes: float
    act_bytes_per_layer: float     # activation bytes / layer for global batch
    n_layers: int
    batch: int
    # classifier-head term (the paper's Fig-4/5 case): logits bytes / step
    logits_bytes: float = 0.0
    head_param_bytes: float = 0.0
    # grad/optimizer bytes per param byte (AdamW fp32: grads 1 + m 1 + v 1)
    opt_state_factor: float = 2.0
    grad_factor: float = 1.0
    # MoE terms (zero for dense models — every ep-aware path then
    # reduces exactly to the flat pricing):
    n_experts: int = 0             # routed experts per MoE layer
    n_moe_layers: int = 0          # layers carrying an expert block
    expert_param_bytes: float = 0.0   # total expert-weight bytes (all layers)
    # routed-token dispatch buffer bytes per MoE layer, global batch
    # (B·S·top_k·capacity_factor·d_model·act_bytes) — the all-to-all payload
    moe_dispatch_bytes: float = 0.0


# ---------------------------------------------------------------------------
# segment-aware workload description (the M6 multimodal path)
# ---------------------------------------------------------------------------
#
# ``WorkloadMeta`` is layer-homogeneous: one ``fwd_flops`` total, one
# ``act_bytes_per_layer``, and every layer interchangeable.  That cannot
# describe M6 — a vision frontend stitched to a text decoder — where a
# pipeline cut between the modalities is the whole point (HetPipe's
# per-segment cost problem).  A :class:`ModelGraph` is the richer
# description: an ordered sequence of :class:`SegmentMeta` spans, each
# internally homogeneous, with the legacy flat meta recoverable as the
# flattened sum (``workload_meta()``) so every existing ``step_cost`` /
# ``auto.search`` / calibration call site keeps pricing byte-identically.


@dataclasses.dataclass(frozen=True)
class SegmentMeta:
    """One contiguous, internally homogeneous span of a model graph.

    ``n_layers`` are interchangeable *within* the segment (the unit the
    stage balancer moves); flops/params/activations are totals for the
    whole segment at the graph's global batch.  ``atomic`` spans (vision
    towers, fused frontends) may never be split across pipeline stages.
    """
    name: str
    n_layers: int
    fwd_flops: float
    param_bytes: float
    act_bytes_per_layer: float
    atomic: bool = False
    # MoE terms for segments carrying expert blocks (zero elsewhere)
    n_experts: int = 0
    n_moe_layers: int = 0
    expert_param_bytes: float = 0.0
    moe_dispatch_bytes: float = 0.0

    def __post_init__(self):
        if self.n_layers < 1:
            raise ValueError(f"segment {self.name!r} needs >=1 layer")
        if self.n_moe_layers > self.n_layers:
            raise ValueError(f"segment {self.name!r}: n_moe_layers "
                             f"{self.n_moe_layers} > n_layers {self.n_layers}")


@dataclasses.dataclass(frozen=True)
class ModelGraph:
    """An ordered sequence of heterogeneous segments + stack-external terms.

    The stack-external terms (embeddings/head params, the lm-head matmul,
    logits) are not owned by any segment; flattening and per-stage slicing
    spread them evenly across layers, exactly as the legacy
    ``scale_meta_stage`` view did.

    ``workload_meta()`` flattens to the legacy :class:`WorkloadMeta`; for
    the single-segment graphs the per-family builders in
    :mod:`repro_torch.models.lm` produces (dense and ssm so far), the
    flattening is **byte-identical** to the reference's
    (``tests/test_torch_planning.py``).
    """
    name: str
    segments: tuple
    batch: int
    extra_fwd_flops: float = 0.0      # lm-head matmul and friends
    extra_param_bytes: float = 0.0    # embeddings / head / final norm
    logits_bytes: float = 0.0
    head_param_bytes: float = 0.0
    opt_state_factor: float = 2.0
    grad_factor: float = 1.0
    # fraction of param bytes a tp `split` can shard (norms/bias stay
    # replicated); the taskgraph deriver uses a different constant, which
    # is why this is a field and not hard-coded in the flatten
    tp_shardable_fraction: float = 0.98

    def __post_init__(self):
        if not self.segments:
            raise ValueError("ModelGraph needs at least one segment")

    # ---- structure --------------------------------------------------------

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.segments)

    def boundaries(self) -> tuple:
        """Cumulative segment edges: (0, l₀, l₀+l₁, …, L)."""
        out, off = [0], 0
        for s in self.segments:
            off += s.n_layers
            out.append(off)
        return tuple(out)

    def segment_spans(self) -> tuple:
        """Per-segment ``(start, stop)`` layer offsets."""
        b = self.boundaries()
        return tuple(zip(b[:-1], b[1:]))

    def valid_span(self, lo: int, hi: int) -> bool:
        """May layers ``[lo, hi)`` form one pipeline stage?

        The segment-respecting rule: a stage boundary may fall anywhere
        *between* layers EXCEPT inside an ``atomic`` segment (a fused
        frontend tower is one indivisible unit — a stage either contains
        it whole or not at all).  Non-atomic segments may be subdivided
        freely; segment edges matter to the balancer because per-layer
        costs change across them, not because cuts are forbidden near
        them.
        """
        if not (0 <= lo < hi <= self.n_layers):
            return False
        for s, (s0, s1) in zip(self.segments, self.segment_spans()):
            if not s.atomic:
                continue
            ov = min(hi, s1) - max(lo, s0)
            if 0 < ov < s1 - s0:     # partial coverage of an atomic span
                return False
        return True

    def valid_partition(self, layer_counts) -> bool:
        """Do the per-stage layer counts cut only at valid span edges?"""
        if sum(layer_counts) != self.n_layers:
            return False
        off = 0
        for n in layer_counts:
            if n < 1 or not self.valid_span(off, off + n):
                return False
            off += n
        return True

    def feasible_pp(self, pp: int) -> bool:
        """Does ANY segment-respecting partition into ``pp`` stages exist?"""
        if pp < 1:
            return False
        if pp == 1:
            return True
        L = self.n_layers
        # dp over cut positions: reach[k] = set of prefixes coverable by k
        # valid spans.  L is a few hundred at most — this is cheap.
        reach = {0}
        for _ in range(pp - 1):
            reach = {m for c in reach for m in range(c + 1, L)
                     if self.valid_span(c, m)}
            if not reach:
                return False
        return any(self.valid_span(c, L) for c in reach)

    def layer_costs(self) -> list:
        """Per-layer forward FLOPs (stack-external flops spread evenly) —
        the weights the segment-aware stage balancer allocates against."""
        L = self.n_layers
        extra = self.extra_fwd_flops / L
        out = []
        for s in self.segments:
            out.extend([s.fwd_flops / s.n_layers + extra] * s.n_layers)
        return out

    # ---- flattening -------------------------------------------------------

    def workload_meta(self) -> WorkloadMeta:
        """Flatten to the legacy layer-homogeneous :class:`WorkloadMeta`.

        Association order matches the retired if-ladder (flops summed
        first, the head added last; shardable bytes derived from the final
        param total) so single-segment graphs flatten byte-identically.
        """
        flops = 0.0
        pbytes = 0.0
        exp_bytes = 0.0
        for s in self.segments:
            flops += s.fwd_flops
            pbytes += s.param_bytes
            exp_bytes += s.expert_param_bytes
        flops += self.extra_fwd_flops
        pbytes += self.extra_param_bytes
        n_moe = sum(s.n_moe_layers for s in self.segments)
        return WorkloadMeta(
            name=self.name,
            fwd_flops=float(flops),
            param_bytes=float(pbytes),
            tp_shardable_param_bytes=float(pbytes
                                           * self.tp_shardable_fraction),
            act_bytes_per_layer=float(max(s.act_bytes_per_layer
                                          for s in self.segments)),
            n_layers=max(self.n_layers, 1),
            batch=self.batch,
            logits_bytes=float(self.logits_bytes),
            head_param_bytes=float(self.head_param_bytes),
            opt_state_factor=self.opt_state_factor,
            grad_factor=self.grad_factor,
            n_experts=max((s.n_experts for s in self.segments), default=0),
            n_moe_layers=int(n_moe),
            expert_param_bytes=float(exp_bytes),
            moe_dispatch_bytes=float(max(s.moe_dispatch_bytes
                                         for s in self.segments)))

    def stage_meta(self, lo: int, hi: int, pp: int) -> WorkloadMeta:
        """The workload as seen by ONE stage holding layers ``[lo, hi)``.

        The per-segment counterpart of ``hetero.scale_meta_stage``: slice
        totals come from the covering segments' own arithmetic instead of
        a uniform ``layers/L`` fraction; the ``·pp`` re-scaling convention
        (``step_cost`` divides by ``pp`` internally) and the keep-whole
        treatment of logits/head are identical.  On a single-segment graph
        this IS ``scale_meta_stage`` of the flattened meta.
        """
        if not (0 <= lo < hi <= self.n_layers):
            raise ValueError(f"bad stage span [{lo}, {hi}) of "
                             f"{self.n_layers} layers")
        n = hi - lo
        flops = pbytes = exp = 0.0
        act = disp = 0.0
        nmoe = 0.0
        nexp = 0
        for s, (s0, s1) in zip(self.segments, self.segment_spans()):
            ov = min(hi, s1) - max(lo, s0)
            if ov <= 0:
                continue
            frac = ov / s.n_layers
            flops += s.fwd_flops * frac
            pbytes += s.param_bytes * frac
            act = max(act, s.act_bytes_per_layer)
            nmoe += s.n_moe_layers * frac
            exp += s.expert_param_bytes * frac
            disp = max(disp, s.moe_dispatch_bytes)
            if s.n_moe_layers:
                nexp = max(nexp, s.n_experts)
        scale = n / self.n_layers
        flops += self.extra_fwd_flops * scale
        pbytes += self.extra_param_bytes * scale
        n_moe_stage = int(round(nmoe))
        return WorkloadMeta(
            name=f"{self.name}[{lo}:{hi}]",
            fwd_flops=float(flops * pp),
            param_bytes=float(pbytes * pp),
            tp_shardable_param_bytes=float(pbytes * pp
                                           * self.tp_shardable_fraction),
            act_bytes_per_layer=float(act),
            n_layers=n * pp,
            batch=self.batch,
            logits_bytes=float(self.logits_bytes),
            head_param_bytes=float(self.head_param_bytes),
            opt_state_factor=self.opt_state_factor,
            grad_factor=self.grad_factor,
            n_experts=nexp if n_moe_stage else 0,
            n_moe_layers=n_moe_stage * pp,
            expert_param_bytes=float(exp * pp),
            moe_dispatch_bytes=float(disp if n_moe_stage else 0.0))

    def describe(self) -> str:
        segs = " → ".join(f"{s.name}×{s.n_layers}" for s in self.segments)
        return f"{self.name}: {segs} ({self.n_layers} layers)"


def as_workload_meta(workload) -> WorkloadMeta:
    """Accept either description; flatten graphs to the legacy meta."""
    if isinstance(workload, ModelGraph):
        return workload.workload_meta()
    return workload


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    compute: float
    comm: float
    bubble: float
    mem_bytes: float
    feasible: bool
    detail: dict

    @property
    def total(self) -> float:
        if not self.feasible:
            return math.inf
        return self.compute + self.comm + self.bubble


def step_cost(meta: WorkloadMeta, strat: StrategySpec, hw: Hardware,
              *, overlap: float = 0.0) -> CostBreakdown:
    """Estimated wall-time of one training step under ``strat`` on ``hw``.

    ``overlap`` ∈ [0, 1): fraction of DP gradient communication hidden under
    backward compute (XLA latency hiding / Horovod fusion both give ~some).
    """
    dp, tp, pp, ep = strat.dp, strat.tp, strat.pp, strat.ep
    detail: dict = {}

    # ---- compute ----
    train_flops = meta.fwd_flops * (4.0 if strat.remat else 3.0)
    # every device computes 1/devices of the work: under nested ep the
    # model axis acts as extra data parallelism for the dense layers and
    # spreads routed tokens across expert shards for the MoE layers
    shards = strat.devices
    t_compute = train_flops / shards / (hw.peak_flops * hw.mxu_eff)
    detail["compute"] = t_compute

    # ---- communication ----
    t_comm = 0.0
    # (a) DP gradient all-reduce (or reduce-scatter+all-gather under ZeRO).
    #     Under nested ep the expert grads are already ep-sharded — their
    #     reduction rides only the (slow) data axis at 1/ep the volume —
    #     while dense-layer grads additionally reduce over the model axis
    #     (its shards saw different batch slices).
    exp_bytes = meta.expert_param_bytes if ep > 1 else 0.0
    grad_bytes = (meta.param_bytes - exp_bytes) * meta.grad_factor / (tp * pp)
    if dp > 1:
        t_dp = all_reduce_time(grad_bytes, dp, hw.bw_for_axis("data"))
        if ep > 1 and exp_bytes:
            t_dp += all_reduce_time(exp_bytes * meta.grad_factor / (ep * pp),
                                    dp, hw.bw_for_axis("data"))
        t_dp *= (1.0 - overlap)
        t_comm += t_dp
        detail["dp_allreduce"] = t_dp
    if ep > 1 and tp == 1:
        # dense grads reduce across the ep shards (fast model axis)
        t_ep_ar = all_reduce_time(grad_bytes, ep, hw.bw_for_axis("model"))
        t_ep_ar *= (1.0 - overlap)
        t_comm += t_ep_ar
        detail["ep_dense_allreduce"] = t_ep_ar
    # (a') expert dispatch/combine all-to-all bridges: 2 forward + 2
    #      backward per MoE layer, each moving the routed-token buffer
    #      (batch-sharded over dp) across the ep group on the model axis
    if ep > 1 and meta.n_moe_layers and meta.moe_dispatch_bytes:
        n_a2a = 4 * max(meta.n_moe_layers // pp, 1)
        t_a2a = n_a2a * all_to_all_time(meta.moe_dispatch_bytes / dp, ep,
                                        hw.bw_for_axis("model"))
        t_comm += t_a2a
        detail["ep_all_to_all"] = t_a2a
    # (b) ZeRO-3 param all-gather each fwd+bwd (2×) over dp — under
    #     nested ep the expert weights are already ep-sharded, so only
    #     1/ep of them is gathered (matching the memory model below)
    if strat.zero >= 3 and dp > 1:
        ag_bytes = ((meta.param_bytes - exp_bytes) / tp
                    + (exp_bytes / ep if ep > 1 else 0.0)) / pp
        t_ag = 2 * all_gather_time(ag_bytes, dp, hw.bw_for_axis("data"))
        t_comm += t_ag
        detail["fsdp_allgather"] = t_ag
    # (c) TP activation all-reduces: 2 per layer fwd, 2 per layer bwd
    #     (Megatron) each moving the layer activation bytes / (dp·pp)
    if tp > 1:
        act = meta.act_bytes_per_layer / dp
        n_ar = 4 * (meta.n_layers // pp)
        t_tp = n_ar * all_reduce_time(act, tp, hw.bw_for_axis("model"))
        t_comm += t_tp
        detail["tp_allreduce"] = t_tp
        if strat.vocab_split and meta.logits_bytes:
            # Fig-4 path: only 3 scalar-ish reductions per loss chunk — model
            # as 3 all-reduces of (B·S) fp32 rows (max/sumexp/correct).
            row_bytes = meta.logits_bytes / max(
                1, (meta.logits_bytes // (4 * meta.batch)) or 1)
            t_head = 3 * all_reduce_time(row_bytes / dp, tp,
                                         hw.bw_for_axis("model"))
            t_comm += t_head
            detail["vocab_split_head"] = t_head
        elif meta.logits_bytes:
            # without the split the full logits must be formed from a
            # replicated head — an all-gather of the logits over tp
            t_head = all_gather_time(meta.logits_bytes / dp, tp,
                                     hw.bw_for_axis("model"))
            t_comm += t_head
            detail["head_allgather"] = t_head
    # (d) pipeline p2p: 2 transfers (fwd + bwd) of the boundary activation
    #     per micro-batch per stage boundary
    if pp > 1:
        act_mb = meta.act_bytes_per_layer / dp / max(strat.micro_batches, 1)
        t_pp = 2 * (pp - 1) * strat.micro_batches * p2p_time(
            act_mb, hw.bw_for_axis("stage"))
        t_comm += t_pp
        detail["pipeline_p2p"] = t_pp
    detail["comm"] = t_comm

    # ---- pipeline bubble ----
    # (S−1)/(M+S−1) for both shipped schedules — 1F1B reorders work inside
    # the span, it does not shrink it (repro_torch.core.schedule validates the
    # tick tables against this closed form)
    t_bubble = 0.0
    if pp > 1:
        from repro_torch.core.schedule import bubble_fraction_closed_form
        m = max(strat.micro_batches, 1)
        t_bubble = t_compute * bubble_fraction_closed_form(pp, m)
    detail["bubble"] = t_bubble

    # ---- memory ----
    # params: sharded by tp (shardable part) & pp; zero-3 also by dp;
    # under nested ep the expert weights shard ep-ways instead (the M6
    # feasibility lever: flat DP replicates every expert on every device)
    if ep > 1 and meta.expert_param_bytes:
        exp = min(meta.expert_param_bytes, meta.tp_shardable_param_bytes)
        p_shard = (exp / ep + (meta.tp_shardable_param_bytes - exp) / tp
                   + (meta.param_bytes - meta.tp_shardable_param_bytes)) / pp
        sharded_bytes = exp / ep + (meta.param_bytes - exp) / tp
    else:
        p_shard = (meta.tp_shardable_param_bytes / tp
                   + (meta.param_bytes - meta.tp_shardable_param_bytes)) / pp
        sharded_bytes = meta.param_bytes / tp
    if strat.zero >= 3:
        p_shard /= dp
    opt_factor = 0.05 if strat.opt_factored else meta.opt_state_factor
    opt = sharded_bytes * opt_factor / pp
    if strat.zero >= 1:
        opt /= dp
    grads = sharded_bytes * meta.grad_factor / pp
    if strat.zero >= 2:
        grads /= dp
    # activations: with remat only ~1 layer's working set + per-layer
    # residuals are live; without, all layers.  Under nested ep with no
    # tensor split the model axis is extra data parallelism for the dense
    # layers, so the batch (and with it the activation working set)
    # shards over dp·ep; with ep == tp the model axis is doing tensor
    # parallelism and the batch stays dp-sharded (flat accounting).
    mb = max(strat.micro_batches, 1)
    act_dp = dp * (ep if (ep > 1 and tp == 1) else 1)
    act_live = meta.act_bytes_per_layer / act_dp / mb * (
        2.0 + (0 if strat.remat else meta.n_layers / pp))
    if pp > 1:
        # schedule-dependent in-flight micro-batches: GPipe must buffer all
        # M at its peak, 1F1B caps at min(M, S) (repro_torch.core.schedule)
        from repro_torch.core.schedule import in_flight_micro_batches
        act_live *= in_flight_micro_batches(pp, mb, strat.schedule)
    logits_live = 0.0
    if meta.logits_bytes:
        logits_live = meta.logits_bytes / act_dp / (
            tp if strat.vocab_split else 1)
        if strat.vocab_split:
            logits_live = min(logits_live, meta.logits_bytes / act_dp / tp)
    mem = p_shard + opt + grads + act_live + logits_live
    detail["mem"] = mem

    feasible = mem <= hw.hbm_bytes
    return CostBreakdown(compute=t_compute, comm=t_comm, bubble=t_bubble,
                         mem_bytes=mem, feasible=feasible, detail=detail)


# ---------------------------------------------------------------------------
# linear decomposition for profile-guided calibration (repro_torch.core.calibrate)
# ---------------------------------------------------------------------------
#
# step_cost is *linear in the reciprocals* of the hardware parameters: every
# term is (a byte/FLOP volume that depends only on meta+strat) divided by
# one hardware rate.  step_cost_features extracts those volumes, so that
#
#     step_cost(meta, strat, hw).total
#         ≈ Σ_p  step_cost_features(...)[p] · hardware_reciprocals(hw)[p]
#
# (equality up to float re-association; the reference's
# tests/test_calibration.py guards the identity at 1e-9 relative).
# calibrate.fit inverts this: given measured (features, wall-time)
# observations it least-squares-solves for the reciprocals — i.e. for the
# Hardware table itself.

CALIBRATION_PARAMS = ("eff_flops", "hbm_bw", "link_fast", "link_slow")


def hardware_reciprocals(hw: Hardware) -> dict:
    """The coordinates calibration solves for: ``param → 1/rate``.

    ``eff_flops`` is the *effective* matmul rate (peak × mxu_eff) — the
    only combination a wall-clock measurement can see; ``calibrate.fit``
    maps it back to ``peak_flops`` holding ``mxu_eff`` at its prior.
    """
    return {
        "eff_flops": 1.0 / (hw.peak_flops * hw.mxu_eff),
        "hbm_bw": 1.0 / hw.hbm_bw,
        "link_fast": 1.0 / hw.link_bw["fast"],
        "link_slow": 1.0 / hw.link_bw["slow"],
    }


def predict_step_time(features: Mapping[str, float], hw: Hardware) -> float:
    """Price a feature vector on ``hw``: features · reciprocals."""
    recips = hardware_reciprocals(hw)
    return sum(c * recips[p] for p, c in features.items() if c)


def step_cost_features(meta: WorkloadMeta, strat: StrategySpec, hw: Hardware,
                       *, overlap: float = 0.0) -> dict:
    """Per-hardware-parameter coefficients of one training step.

    Mirrors :func:`step_cost` term by term, accumulating *effective byte
    volumes* (ring-formula factors and overlap applied, bandwidth divided
    out) per link kind and the per-device FLOP volume (bubble factor
    applied) instead of times.  ``hw`` only contributes its ``axis_kind``
    mapping — which mesh axis rides the fast vs the slow link — never a
    rate, so the same features can be priced on any candidate table.

    ``hbm_bw`` stays 0 here: the training-step model has no explicit HBM
    term.  It is fed by per-kernel observations
    (:meth:`repro_torch.runtime.profiler.Profiler.record_kernel`, with
    the kernel's traffic bytes) and by the serving rooflines, which are
    HBM-bound.
    """
    dp, tp, pp, ep = strat.dp, strat.tp, strat.pp, strat.ep
    feats = dict.fromkeys(CALIBRATION_PARAMS, 0.0)

    def kind(axis: str) -> str:
        return "link_" + hw.axis_kind.get(axis, "fast")

    # ---- compute (+ pipeline bubble, which scales the compute term) ----
    train_flops = meta.fwd_flops * (4.0 if strat.remat else 3.0)
    bubble = 0.0
    if pp > 1:
        from repro_torch.core.schedule import bubble_fraction_closed_form
        bubble = bubble_fraction_closed_form(pp, max(strat.micro_batches, 1))
    feats["eff_flops"] = train_flops / strat.devices * (1.0 + bubble)

    # ---- communication (same accounting as step_cost, bw = 1) ----
    exp_bytes = meta.expert_param_bytes if ep > 1 else 0.0
    grad_bytes = (meta.param_bytes - exp_bytes) * meta.grad_factor / (tp * pp)
    if dp > 1:
        b = all_reduce_time(grad_bytes, dp, 1.0)
        if ep > 1 and exp_bytes:
            b += all_reduce_time(exp_bytes * meta.grad_factor / (ep * pp),
                                 dp, 1.0)
        feats[kind("data")] += b * (1.0 - overlap)
    if ep > 1 and tp == 1:
        feats[kind("model")] += (all_reduce_time(grad_bytes, ep, 1.0)
                                 * (1.0 - overlap))
    if ep > 1 and meta.n_moe_layers and meta.moe_dispatch_bytes:
        n_a2a = 4 * max(meta.n_moe_layers // pp, 1)
        feats[kind("model")] += n_a2a * all_to_all_time(
            meta.moe_dispatch_bytes / dp, ep, 1.0)
    if strat.zero >= 3 and dp > 1:
        ag_bytes = ((meta.param_bytes - exp_bytes) / tp
                    + (exp_bytes / ep if ep > 1 else 0.0)) / pp
        feats[kind("data")] += 2 * all_gather_time(ag_bytes, dp, 1.0)
    if tp > 1:
        act = meta.act_bytes_per_layer / dp
        n_ar = 4 * (meta.n_layers // pp)
        feats[kind("model")] += n_ar * all_reduce_time(act, tp, 1.0)
        if strat.vocab_split and meta.logits_bytes:
            row_bytes = meta.logits_bytes / max(
                1, (meta.logits_bytes // (4 * meta.batch)) or 1)
            feats[kind("model")] += 3 * all_reduce_time(row_bytes / dp, tp,
                                                        1.0)
        elif meta.logits_bytes:
            feats[kind("model")] += all_gather_time(meta.logits_bytes / dp,
                                                    tp, 1.0)
    if pp > 1:
        act_mb = meta.act_bytes_per_layer / dp / max(strat.micro_batches, 1)
        feats[kind("stage")] += (2 * (pp - 1) * strat.micro_batches
                                 * p2p_time(act_mb, 1.0))
    return feats


def throughput(meta: WorkloadMeta, strat: StrategySpec, hw: Hardware,
               **kw) -> float:
    """Samples/sec for the workload's global batch under the strategy."""
    c = step_cost(meta, strat, hw, **kw)
    if not c.feasible:
        return 0.0
    return meta.batch / c.total


# ---------------------------------------------------------------------------
# serving (inference) pricing: prefill is FLOPs-bound, decode is HBM-bound
# ---------------------------------------------------------------------------
#
# The training cost above prices one *synchronous step*; serving needs two
# different per-group quantities (DESIGN.md §9, the HexiScale lens):
#
# - **prefill**: one prompt's forward is a dense matmul pass — compute-bound,
#   so a group's prefill rate tracks its effective FLOP/s.
# - **decode**: one token per sequence per step — every step re-reads the
#   weights plus the live KV cache from HBM while doing ~2 FLOPs per byte,
#   so a group's decode rate tracks its aggregate HBM bandwidth.
#
# Both are max(flops-term, bytes-term) rooflines on the same Hardware
# tables the training model uses; the reference's prefill/decode router
# (serving/router.py) prices cluster partitions with exactly these two
# functions, which is what makes "prefill on the compute-rich pool, decode
# on the bandwidth-rich pool" fall out of the tables instead of being
# hard-coded.


@dataclasses.dataclass(frozen=True)
class ServingMeta:
    """Per-token metadata of one LM for inference pricing.

    Like :class:`WorkloadMeta` everything is pure arithmetic over the
    config — nothing is executed.  ``flops_per_token`` covers the linear
    (weight) matmuls; attention-over-context adds
    ``attn_flops_per_ctx_token`` per (new token × cached token) pair.
    """
    name: str
    flops_per_token: float           # weight-matmul fwd FLOPs per token
    attn_flops_per_ctx_token: float  # score+value FLOPs per context token
    param_bytes: float               # serving weights (act dtype, e.g. bf16)
    kv_bytes_per_token: float        # KV-cache bytes per cached token, all layers
    d_model: int
    n_layers: int


def lm_serving_meta(cfg, *, param_dtype_bytes: int = 2,
                    kv_dtype_bytes: int = 2) -> ServingMeta:
    """Analytic serving metadata for one LMCfg (attention families)."""
    E, L, hd = cfg.d_model, cfg.n_layers, cfg.hd
    H, K, V = cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab
    proj = 2 * E * (H * hd) + 2 * 2 * E * (K * hd) + 2 * (H * hd) * E
    mlp = 2 * E * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    head = 2 * E * V
    flops_per_token = L * (proj + mlp) + head
    # per (new token, cached token): one q·k dot + one p·v accumulate per head
    attn_per_ctx = L * 2 * H * hd * 2
    param_count = (L * (E * (H * hd) * 2 + E * (K * hd) * 2
                        + E * cfg.d_ff * (3 if cfg.gated_mlp else 2))
                   + V * E * (1 if cfg.tie_embeddings else 2))
    kv_per_token = L * 2 * K * hd * kv_dtype_bytes
    return ServingMeta(
        name=cfg.name, flops_per_token=float(flops_per_token),
        attn_flops_per_ctx_token=float(attn_per_ctx),
        param_bytes=float(param_count * param_dtype_bytes),
        kv_bytes_per_token=float(kv_per_token),
        d_model=E, n_layers=L)


def prefill_time(meta: ServingMeta, group: DeviceGroup,
                 prompt_len: int, batch: int = 1) -> float:
    """Wall time for one prefill of ``batch`` prompts on ``group``.

    FLOPs-bound roofline: dense matmuls over the whole prompt, floored by
    one streaming pass over the (group-sharded) weights.
    """
    T = batch * prompt_len
    flops = T * meta.flops_per_token \
        + batch * (prompt_len * prompt_len / 2) * meta.attn_flops_per_ctx_token
    t_flops = flops / group.group_flops
    t_bytes = meta.param_bytes / (group.n_devices * group.hw.hbm_bw)
    return max(t_flops, t_bytes)


def decode_step_time(meta: ServingMeta, group: DeviceGroup,
                     active: int, ctx_tokens: float) -> float:
    """Wall time of ONE decode step advancing ``active`` sequences on
    ``group``, with ``ctx_tokens`` total KV-cache tokens *read* that step.

    HBM-bound roofline: every step streams the weights plus the live KV.
    ``ctx_tokens`` is where paged beats dense: a dense cache reads its
    full ``slots × max_len`` reservation, a paged cache only the tokens
    actually cached (the block table never materialises the gap pages).
    """
    if active <= 0:
        return 0.0
    bytes_ = meta.param_bytes + ctx_tokens * meta.kv_bytes_per_token
    t_bytes = bytes_ / (group.n_devices * group.hw.hbm_bw)
    flops = active * meta.flops_per_token \
        + ctx_tokens * meta.attn_flops_per_ctx_token
    t_flops = flops / group.group_flops
    return max(t_bytes, t_flops)


def kv_handoff_time(meta: ServingMeta, prompt_len: int, bw: float) -> float:
    """Moving one prompt's KV cache between disaggregated pools."""
    return prompt_len * meta.kv_bytes_per_token / bw


def serving_page_budget(meta: ServingMeta, group: DeviceGroup,
                        page_size: int, *, reserve: float = 0.2) -> int:
    """How many KV pages a decode pool can hold: group HBM minus the
    (sharded) weights minus a ``reserve`` fraction for activations."""
    free = group.n_devices * group.hw.hbm_bytes * (1.0 - reserve) \
        - meta.param_bytes
    page_bytes = page_size * meta.kv_bytes_per_token
    return max(int(free // page_bytes), 0)
