"""Training driver (CLI).

config → model → Whale plan (mesh) → optimizer → data pipeline → train
step → fault-tolerant loop with checkpoints and auto-resume, as
``repro/launch/train.py``.  ``--mesh`` lays the ranks out as the
reference reads it (``data``, ``data × model``, ``pod × data × model``);
the plan trains data-parallel over ``pod`` and ``data`` and splits the
model over ``model`` (tensor parallelism: heads, MLP columns, whole
experts of an MoE, the vocab-parallel embedding and loss head), and
``--compress-pod`` sends the cross-pod gradient reduction through the
int8 error-feedback compressor (``optim/grad_compress.py``, the quant
kernels), each rank compressing its block of every leaf against the whole
leaf's scale.  ``--zero N`` shards the optimizer state (1, 2) or also the
parameters and gradients (3) over the data axes, inside each pod beside
``--compress-pod``.  A sharded run's
checkpoint is the reference's, gathered onto rank 0, which alone writes;
on resume every rank reads it and keeps its blocks.

Pipelines, as the reference's driver runs them: ``--pp S`` lays the world
out as ``stage S × data (world / S)`` and trains through the multi-rank
pipeline engine (``core/pipeline.py``) under ``--schedule`` (``gpipe`` or
``1f1b``; default the plan's) over ``--micro-batches``, with
``--stage-layers`` for uneven stages (default even).  Its checkpoint is
the reference's: parameters and optimizer state in ``pipeline_params``'
padded ``(S·Lmax, …)`` layout, gathered onto rank 0, which alone writes;
on resume every rank reads it and keeps its rows.

Planning, as the reference's driver plans: ``--auto`` prices the model's
segment graph on the ``--hw`` table (default ``h100``, the card the port
runs on) with :func:`~repro_torch.core.auto.auto_parallel` over the
world's devices, prints ``[auto] chose: …`` and trains that strategy
through :func:`~repro_torch.core.planner.compile_plan`: data parallelism,
a model axis, ZeRO, a pipeline, or Whale's nested hybrid, a pipeline
whose stages are split over a model axis (on 4 ranks of the paper's V100
table tinyllama at 4 x 2048 gets ``split×2 pipeline×2(µb=4)``, and so
does the smoke config at 4 x 32); the ``[plan]`` line names the mesh,
the split and the stage layers.  ZeRO inside a pipeline runs as the
reference runs it, sharding nothing over data, and a line says so.
``--profile`` records every step after the first as an observation
against the strategy's cost-model features and prints the calibration
report at exit (fitted rates, the prediction error before and after the
fit).  A :class:`~repro_torch.runtime.straggler.StragglerMonitor` watches
every step's time and prints ``[straggler] flagged …`` on a sustained
outlier.  mamba2 (``--arch mamba2-1.3b``) trains through the
differentiable chunked SSD scan, as the reference trains it; its tied
head runs through the fused cross-entropy kernels.  A model with experts
(``--arch deepseek-moe-16b``, and the hybrid ``--arch jamba-v0.1-52b``,
whose odd blocks carry them) prints each step's ``moe_lb`` and ``moe_z``
(its load-balance and router z-losses, summed over the layers) beside
the loss.  jamba's SSD mixers train through the same scan as mamba2's;
its recipe is the reference's for the ≥ 50B archs, ``--optimizer
adafactor``, as grok-1-314b's is (``--arch grok-1-314b``: 8 experts of
32768 columns, top-2; over a model axis that does not divide its experts
each expert's d_ff splits instead, expert tensor parallelism).  Adafactor
runs beside ``--mesh``, ``--zero`` and ``--pp``, its factored means the
whole leaf's across the blocks a rank holds.

The multimodal families, as the reference's driver trains them: a vlm
(``--arch qwen2-vl-2b``) or encdec arch (``--arch seamless-m4t-medium``)
draws a :class:`~repro_torch.data.pipeline.MultimodalPipeline`, its patch
embeddings or ``--src-seq`` source frames (default ``--seq``) beside the
tokens.  A vlm is never pipelined (``--pp`` exits with the reference's
words; ``--auto`` searches at ``max_pp=1``); an encdec arch at ``--pp 2``
trains through the two-tower engine (the encoder on stage 0, the decoder
and the loss on stage 1; ``--stage-layers`` exits), its state replicated
over the stages.  Neither family splits over ``model`` or takes ZeRO yet
(ROADMAP.md queue A item 7).

``--pp`` lays the ranks out as ``stage × data``, as the reference's
``--pp`` does; beside ``--mesh D`` or ``DxM`` it lays them out as ``stage
× data × model`` (Whale's nested hybrid, which the reference reaches
through ``--auto`` only), and the experts of deepseek-moe-16b or
jamba-v0.1-52b then split whole over ``model`` inside each stage
(``pipeline{split[experts]}``), each stage carrying its experts' aux
losses to the loss (``moe_lb``, ``moe_z`` printed as unpipelined).
mamba2 and jamba pipeline too: a stage holds whole pattern repeats
(jamba's period of 8 blocks), and mamba2's tied table is summed over the
first and the last stage.  A pod axis beside ``--pp`` and
``--compress-pod`` beside a pipeline are refused (the reference's
pipelined step has no compressed reduction).

Whale's elastic runtime, as the reference's driver runs it: ``--hosts N``
deals the launch ranks to N simulated hosts of ``--devices-per-host``
ranks each (default world / N; fewer leave spare ranks for
``--inject-join``) on the ``--hw`` table and trains through the
cluster-membership controller (:mod:`repro_torch.runtime.controller`):
a sustained straggler is flagged and evicted (``--patience``,
``--straggler-warmup``), a spot-reclaimed host is drained before its
deadline, a joining host is admitted, and with ``--calibrate`` a
sustained predicted-vs-measured drift re-fits the cost model's tables
(``--drift-skew``, ``--drift-patience``); after each (at most
``--max-rebalances``) the job re-plans on a new generation of the
process group, restores the committed checkpoint and resumes with
exactly-once data.  ``--inject-slow``, ``--inject-crash``,
``--inject-preempt``, ``--inject-join`` and ``--inject-drift`` play the
reference's fault scenarios on a nominal clock, so every rank takes the
same decision at the same step; ``--profile`` beside ``--hosts`` records
and never rebalances.

Processes: under ``torchrun`` each rank reads its rank and the world from
the environment and uses ``cuda:LOCAL_RANK``; without it, ``--mesh`` of
one device makes a world of one over a ``FileStore`` in the checkpoint
directory.  Collectives go over NCCL on the card and gloo on the CPU.
Without ``--mesh`` and outside ``torchrun`` the run is one device with no
process group.  Runs on the card unless ``--device cpu`` is given; without
a card and without ``--device cpu`` it raises.

Usage::

    python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --batch 4 --seq 2048 --steps 8 --ckpt-dir /path/to/ckpt \
        --mesh 1x1x1 --compress-pod

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \
        --device cpu --mesh 2x2x1 --compress-pod --steps 3 --batch 4 \
        --seq 32 --ckpt-dir "$TMPDIR/ck"

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu --mesh 2x2x1 --compress-pod --zero 3 \
        --steps 3 --batch 4 --seq 32 --ckpt-dir "$TMPDIR/zc"

    python -m repro_torch.launch.train --arch mamba2-1.3b --batch 4 \
        --seq 2048 --steps 4 --ckpt-dir /path/to/ckpt

    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \
        --device cpu --steps 3 --batch 2 --seq 32 --ckpt-dir "$TMPDIR/ck"

    python -m repro_torch.launch.train --arch deepseek-moe-16b \
        --overrides n_layers=2 --batch 4 --seq 2048 --steps 3 \
        --optimizer adamw --ckpt-dir /path/to/ckpt

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu --pp 2 --schedule 1f1b --micro-batches 2 \
        --batch 4 --seq 32 --steps 3 --ckpt-dir "$TMPDIR/pp"

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch deepseek-moe-16b --smoke --device cpu --pp 2 --mesh 1x2 \
        --schedule 1f1b --micro-batches 2 --batch 4 --seq 32 --steps 3 \
        --ckpt-dir "$TMPDIR/ppmoe"

    python -m repro_torch.launch.train --arch jamba-v0.1-52b \
        --overrides n_layers=2,attn_period=2,attn_offset=1 --batch 4 \
        --seq 2048 --steps 3 --optimizer adafactor --ckpt-dir /path

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch mamba2-1.3b --smoke --device cpu --pp 2 --schedule 1f1b \
        --micro-batches 2 --batch 4 --seq 64 --steps 3 --ckpt-dir "$TMPDIR/m"

    python -m repro_torch.launch.train --arch tinyllama-1.1b --batch 4 \
        --seq 2048 --steps 8 --auto --hw h100 --profile --ckpt-dir /path

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu --mesh 2x2 --batch 4 --seq 32 --steps 3 \
        --ckpt-dir "$TMPDIR/tp"

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu --auto --hw v100 --batch 4 --seq 32 \
        --steps 3 --ckpt-dir "$TMPDIR/nested"

    python -m repro_torch.launch.train --arch qwen2-vl-2b --batch 4 \
        --seq 2048 --steps 3 --ckpt-dir /path/to/ckpt

    python -m repro_torch.launch.train --arch seamless-m4t-medium \
        --batch 4 --seq 2048 --src-seq 1024 --steps 3 --ckpt-dir /path

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu --steps 12 --batch 8 --seq 64 --hosts 2 \
        --inject-slow 1:4:5 --straggler-warmup 2 --patience 2 \
        --save-every 4 --ckpt-dir "$TMPDIR/heal"

    torchrun --standalone --nproc-per-node 3 -m repro_torch.launch.train \
        --smoke --device cpu --steps 16 --batch 8 --seq 64 --hosts 2 \
        --devices-per-host 1 --inject-preempt 1:4:2 --inject-join 2:10:1 \
        --save-every 4 --ckpt-dir "$TMPDIR/spot"

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch seamless-m4t-medium --smoke --device cpu --pp 2 \
        --micro-batches 2 --batch 4 --seq 32 --src-seq 24 --steps 3 \
        --ckpt-dir "$TMPDIR/encdec"
"""
from __future__ import annotations

import argparse
import importlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, apply_overrides, get_config
from repro_torch.core.auto import auto_parallel
from repro_torch.core.calibrate import prediction_error
from repro_torch.core.cost_model import (H100_SXM, P100_16G, T4_16G,
                                         TPU_V5E, V100_PAPER, ClusterSpec,
                                         StrategySpec, hardware_reciprocals,
                                         step_cost, step_cost_features)
from repro_torch.core.planner import compile_plan, mesh_for_strategy
from repro_torch.core.schedule import SCHEDULE_NAMES
from repro_torch.data.pipeline import (DataCfg, MultimodalPipeline,
                                       TokenPipeline)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (end_world, leave_group, make_mesh,
                                     mesh_axes, mesh_shape, parse_mesh,
                                     start_world, under_torchrun)
from repro_torch.models.lm import Model, param_count
from repro_torch.optim import grad_compress
from repro_torch.optim.optimizer import Schedule, adafactor, adamw
from repro_torch.runtime.controller import (CalibrationConfig,
                                            ClusterController, ElasticConfig)
from repro_torch.runtime.elastic import HostTopology
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.runtime.faults import (CrashStep, DriftHost, FaultInjector,
                                        JoinHost, SlowHost, SpotPreemption)
from repro_torch.runtime.profiler import Profiler
from repro_torch.runtime.straggler import StragglerMonitor

# ``repro_torch.core`` exports the ``pipeline`` scope under the engine
# module's name, as ``repro.core`` does: reach the module itself
pipe = importlib.import_module("repro_torch.core.pipeline")

#: ``--hw`` → the cost model's table (the reference's four, and the H100)
HW_TABLES = {"tpu_v5e": TPU_V5E, "v100": V100_PAPER, "p100": P100_16G,
             "t4": T4_16G, "h100": H100_SXM}
COMPRESS_PIPE = ("--compress-pod beside a pipeline: the reference's "
                 "pipelined step has no compressed cross-pod reduction")


def _parse_injections(slow: list, crash: list, drift: list = (),
                      preempt: list = (), join: list = ()) -> tuple:
    """The ``--inject-*`` flags → fault scenarios, as the reference reads
    them."""
    scenarios = []
    for s in slow or []:
        host, start, factor = s.split(":")
        scenarios.append(SlowHost(host=int(host), start_step=int(start),
                                  factor=float(factor)))
    for c in crash or []:
        bits = c.split(":")
        scenarios.append(CrashStep(step=int(bits[0]),
                                   times=int(bits[1]) if len(bits) > 1
                                   else 1))
    for d in drift or []:
        host, start, end, factor = d.split(":")
        scenarios.append(DriftHost(host=int(host), start_step=int(start),
                                   end_step=int(end), factor=float(factor)))
    for p in preempt or []:
        bits = p.split(":")
        scenarios.append(SpotPreemption(
            host=int(bits[0]), warn_step=int(bits[1]),
            deadline_steps=int(bits[2]) if len(bits) > 2 else 2))
    for j in join or []:
        host, step, n_dev = j.split(":")
        scenarios.append(JoinHost(host=int(host), step=int(step),
                                  n_devices=int(n_dev)))
    return tuple(scenarios)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", "--model", dest="arch", choices=ARCH_NAMES,
                    default="tinyllama-1.1b",
                    help="architecture to train (--model is an alias)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--src-seq", type=int, default=None,
                    help="encoder-side source length for encdec archs "
                         "(frames per sample); default: --seq")
    ap.add_argument("--micro-batches", type=int, default=None,
                    help="gradient accumulation over M slices, or the "
                         "pipeline's micro-batches; default: the plan's "
                         "choice (1 when unplanned)")
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"),
                    default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint directory; a run resumes from the "
                         "latest committed step found there")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overrides", default="",
                    help="comma k=v LMCfg overrides (e.g. n_layers=4)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--mesh", default="",
                    help="e.g. 4 = data4, 4x1 = data4 x model1, 2x2x1 = "
                         "pod2 x data2 x model1 (ranks = product)")
    ap.add_argument("--compress-pod", action="store_true",
                    help="int8 error-feedback compression of the cross-pod "
                         "gradient reduction (needs a pod axis)")
    ap.add_argument("--zero", type=int, choices=(0, 1, 2, 3), default=0,
                    help="ZeRO stage over the --mesh's data axes (beside "
                         "--compress-pod: inside each pod)")
    ap.add_argument("--distributed", action="store_true",
                    help="require a torchrun world (RANK, WORLD_SIZE, "
                         "MASTER_ADDR, MASTER_PORT in the environment)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (adds a 'stage' mesh axis)")
    ap.add_argument("--schedule", choices=SCHEDULE_NAMES, default=None,
                    help="pipeline schedule (core/schedule.py); default: "
                         "the plan's choice")
    ap.add_argument("--stage-layers", default="",
                    help="comma layer repeats per stage (uneven pipelines, "
                         "e.g. 3,2,2,1); default even split")
    ap.add_argument("--auto", action="store_true",
                    help="pick the strategy with the Whale cost model")
    ap.add_argument("--hw", choices=tuple(HW_TABLES), default="h100",
                    help="Hardware table --auto and --profile price with")
    ap.add_argument("--profile", action="store_true",
                    help="record per-step observations against the cost "
                         "model's features and print the fitted "
                         "calibration report at exit")
    # ---- the elastic runtime (the reference's flags) ----
    ap.add_argument("--hosts", type=int, default=0,
                    help="simulate N hosts over the launch ranks and run "
                         "the cluster-membership controller (straggler "
                         "eviction + rebalance + resume)")
    ap.add_argument("--inject-slow", action="append", default=[],
                    metavar="HOST:STEP:FACTOR",
                    help="fault injection: HOST runs FACTOR× slower from "
                         "STEP (repeatable)")
    ap.add_argument("--inject-crash", action="append", default=[],
                    metavar="STEP[:TIMES]",
                    help="fault injection: transient step failure at STEP")
    ap.add_argument("--inject-preempt", action="append", default=[],
                    metavar="HOST:WARN[:DEADLINE]",
                    help="spot reclaim: HOST is warned at step WARN and "
                         "vanishes DEADLINE steps later (default 2; 0 = "
                         "missed notice, falls back to the last committed "
                         "checkpoint) (repeatable)")
    ap.add_argument("--inject-join", action="append", default=[],
                    metavar="HOST:STEP:NDEV",
                    help="scale-up / spot re-admission: HOST offers NDEV "
                         "ranks from STEP on (repeatable; needs spare "
                         "launch ranks — see --devices-per-host)")
    ap.add_argument("--devices-per-host", type=int, default=0,
                    help="ranks each simulated host owns (default: world "
                         "size / --hosts); set it below that to leave "
                         "spare ranks for --inject-join")
    ap.add_argument("--patience", type=int, default=3)
    ap.add_argument("--straggler-warmup", type=int, default=3)
    ap.add_argument("--max-rebalances", type=int, default=2)
    ap.add_argument("--calibrate", action="store_true",
                    help="drift-triggered continuous rebalancing: compare "
                         "predicted vs measured step cost and rebalance "
                         "with the re-fitted ClusterSpec when skew exceeds "
                         "--drift-skew (needs --hosts)")
    ap.add_argument("--drift-skew", type=float, default=0.25,
                    help="relative skew that triggers recalibration")
    ap.add_argument("--drift-patience", type=int, default=5,
                    help="sustained skewed steps before recalibrating")
    ap.add_argument("--inject-drift", action="append", default=[],
                    metavar="HOST:START:END:FACTOR",
                    help="fault injection: HOST ramps linearly to FACTOR× "
                         "slower between START and END (repeatable)")
    return ap.parse_args(argv)


def _refuse_flags(args) -> None:
    """Flags that cannot go together exit: ``--auto`` with a hand-made
    layout (the reference ignores the layout under ``--auto``), a pod
    axis or ``--compress-pod`` beside a pipeline, and a layout of more
    ranks than a world outside ``torchrun`` holds."""
    if args.auto and (args.mesh or args.pp > 1):
        raise SystemExit("--auto picks the layout itself: drop --mesh and "
                         "--pp")
    if args.auto and args.zero:
        raise SystemExit("--auto picks the ZeRO stage itself: drop --zero")
    if args.pp > 1 and args.mesh and "pod" in mesh_axes(args.mesh)[1]:
        raise SystemExit("--pp beside --mesh takes D or DxM (stage x data "
                         "x model): a pod axis beside a pipeline comes from "
                         "--auto")
    if args.pp > 1 and args.compress_pod:
        raise SystemExit(COMPRESS_PIPE)
    if args.mesh and not under_torchrun():
        n = int(np.prod(mesh_axes(args.mesh)[0])) * args.pp
        if n > 1:
            raise SystemExit(f"--mesh {args.mesh} needs {n} ranks: run it "
                             f"under torchrun --nproc-per-node {n}")


def _start_world(args, device: torch.device):
    """(device, FileStore path or None) after making the default process
    group where this run needs one and none exists: under torchrun from
    its environment, else a world of one over a FileStore in the
    checkpoint directory (:func:`~repro_torch.launch.mesh.start_world`).
    Returns (device, None) when the group was made by the caller, and no
    group at all without --mesh outside torchrun."""
    if dist.is_initialized():
        return device, None
    torchrun = under_torchrun()
    if args.distributed and not torchrun:
        raise SystemExit("--distributed needs a torchrun world: RANK, "
                         "WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the "
                         "environment")
    if not (torchrun or args.mesh):
        return device, None
    return start_world(device, args.ckpt_dir)


def auto_strategy(graph, world: int, hw, max_pp: int | None = None):
    """``--auto``: the cost model's best strategy for ``graph`` over
    ``world`` devices of ``hw`` (at most ``max_pp`` stages), as the
    reference's driver picks it; no feasible strategy exits."""
    kw = {} if max_pp is None else {"max_pp": max_pp}
    try:
        return auto_parallel(graph, world, hw, **kw)
    except RuntimeError as e:              # nothing fits the table's HBM
        raise SystemExit(f"--auto: {e}") from None


def profile_summary(profiler: Profiler, hw, world: int,
                    group: str | None = None) -> dict:
    """The calibration report of ``--profile`` and its numbers for the
    device group ``group`` (default ``hw.name``, the group of a run without
    ``--hosts``): the fitted rates beside the table's, their confidences,
    and the mean relative prediction error over the observations before
    and after the fit."""
    group = group or hw.name
    window = profiler.window(group)
    fitted = profiler.fit_group(group, hw)
    return {
        "hw": hw.name, "observations": len(window),
        "rates": {p: 1.0 / x for p, x in
                  hardware_reciprocals(fitted).items()},
        "prior_rates": {p: 1.0 / x for p, x in
                        hardware_reciprocals(hw).items()},
        "confidence": dict(fitted.confidence),
        "error_before": prediction_error(window, hw),
        "error_after": prediction_error(window, fitted),
        "report": profiler.report(ClusterSpec.homogeneous(hw, world,
                                                          name=group)),
    }


def main(argv=None) -> dict:
    """Train; returns {"final_step", "losses", "step_seconds", "mesh",
    "strategy", "predicted_step_s"}, for an MoE "moe_lb" and "moe_z" (per
    step), and with ``--profile`` "profile"
    (each step's wall time, ending after the device finished the step;
    the mesh's {axis: size}, or None for one device without a process
    group; the executed strategy's ``describe()``; its step time on the
    ``--hw`` table; :func:`profile_summary`)."""
    args = parse_args(argv)
    _refuse_flags(args)
    device, store = _start_world(args, resolve_device(args.device))
    try:
        if args.hosts > 1:
            return _train_elastic(args, device)
        return _train(args, device)
    finally:
        end_world(store)


def _optimizer(args):
    sched = Schedule(base_lr=args.lr, warmup=min(100, args.steps // 10 + 1),
                     decay_steps=args.steps)
    return (adamw(lr=sched) if args.optimizer == "adamw"
            else adafactor(lr=sched))


def _data_pipeline(args, cfg) -> TokenPipeline:
    """The global stream: every rank draws the same global batch (one
    stream, as the reference's) and trains on its rows of it."""
    dcfg = DataCfg(global_batch=args.batch, seq_len=args.seq,
                   vocab=cfg.vocab, seed=args.seed)
    if cfg.family in ("vlm", "encdec"):
        # the modality stream beside the tokens: patch embeddings for a
        # vlm, source frames for an encoder–decoder
        return MultimodalPipeline(
            dcfg, modality=cfg.family, d_model=cfg.d_model,
            frontend_len=cfg.frontend_len if cfg.family == "vlm" else 0,
            src_len=(args.src_seq or args.seq) if cfg.family == "encdec"
            else 0, host_id=0, n_hosts=1)
    return TokenPipeline(dcfg, host_id=0, n_hosts=1)


def _train_elastic(args, device: torch.device) -> dict:
    """``--hosts``: the launch ranks dealt to simulated hosts, trained
    through the :class:`~repro_torch.runtime.controller.ClusterController`
    as the reference's driver trains them (its checks, words and lines;
    the hosts' hardware is the ``--hw`` table).  Returns
    {"final_step", "losses", "events", "phase"}, and where the controller
    watched its cost model (``--calibrate``, ``--profile``) "profile":
    each device group's :func:`profile_summary`."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if args.devices_per_host:
        if args.hosts * args.devices_per_host > n:
            raise SystemExit(
                f"--hosts {args.hosts} × --devices-per-host "
                f"{args.devices_per_host} exceeds the device count ({n})")
        dph = args.devices_per_host
    else:
        if n % args.hosts:
            raise SystemExit(f"--hosts {args.hosts} must divide the "
                             f"device count ({n})")
        dph = n // args.hosts
    hw = HW_TABLES[args.hw]
    topology = HostTopology.uniform(args.hosts, dph, hw)
    scenarios = _parse_injections(args.inject_slow, args.inject_crash,
                                  args.inject_drift, args.inject_preempt,
                                  args.inject_join)
    # nominal clock: injected scenarios play on a fully simulated
    # timeline, so detection is deterministic regardless of machine load
    # and the same on every rank (without one the ranks' measured times
    # are all-gathered each step)
    injector = (FaultInjector(scenarios=scenarios, n_hosts=args.hosts,
                              seed=args.seed, nominal=0.05)
                if scenarios else None)
    calibration = None
    if args.calibrate:
        calibration = CalibrationConfig(
            skew=args.drift_skew, patience=args.drift_patience,
            max_rebalances=args.max_rebalances)
    elif args.profile:
        # record + report only: never trigger a rebalance
        calibration = CalibrationConfig(max_rebalances=0)
    cfg = apply_overrides(get_config(args.arch, smoke=args.smoke),
                          args.overrides)
    ctl = ClusterController(
        Model(cfg, device), cfg, _optimizer(args),
        _data_pipeline(args, cfg), CheckpointManager(args.ckpt_dir, keep=2),
        elastic=ElasticConfig(topology=topology, patience=args.patience,
                              warmup=args.straggler_warmup,
                              max_rebalances=args.max_rebalances,
                              calibration=calibration),
        batch=args.batch, seq=args.seq, save_every=args.save_every,
        injector=injector, log_every=args.log_every)
    out = ctl.run(args.steps, seed=args.seed)
    # the run ends on a group over the launch world: its rank 0 prints
    log = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    spec = ctl.topology.cluster_spec()
    result = {"final_step": out["final_step"], "losses": out["losses"],
              "events": out["events"], "phase": out["phase"]}
    if calibration is not None:
        if args.profile:
            log(ctl.profiler.report(spec), flush=True)
        result["profile"] = {
            g.name: profile_summary(ctl.profiler, g.hw, g.n_devices,
                                    group=g.name)
            for g in spec.groups if ctl.profiler.n_obs(g.name)}
    evictions = [e for e in out["events"] if e["kind"] == "evict"]
    recals = [e for e in out["events"] if e["kind"] == "recalibrate"]
    joins = [e for e in out["events"] if e["kind"] == "join"]
    loss_str = (f", loss {out['losses'][0]:.4f} → {out['losses'][-1]:.4f}"
                if out["losses"] else " (resumed already complete)")
    log(f"[done] step {out['final_step']} phase {out['phase']}, "
        f"{len(evictions)} eviction(s), {len(recals)} recalibration(s), "
        f"{len(joins)} join(s){loss_str}", flush=True)
    # the last generation may still be forming on a peer: leave it only
    # when every rank has come here (gloo fails the peer of an early leaver)
    leave_group()
    return result


def _train(args, device: torch.device) -> dict:
    cfg = apply_overrides(get_config(args.arch, smoke=args.smoke),
                           args.overrides)
    model = Model(cfg, device)
    world = dist.is_initialized()
    rank = dist.get_rank() if world else 0
    log = (lambda *a: print(*a, flush=True)) if rank == 0 else \
        (lambda *a: None)
    n_dev = dist.get_world_size() if world else 1
    hw = HW_TABLES[args.hw]
    src_seq = args.src_seq or args.seq
    graph = model.graph(args.batch, args.seq, src_seq=src_seq)
    strat = None
    if args.auto:
        # the executable stack engine has no slot for the vision frontend
        # or the M-RoPE positions: a vlm is never pipelined
        strat = auto_strategy(graph, n_dev, hw,
                              max_pp=1 if cfg.family == "vlm" else None)
        log(f"[auto] chose: {strat.describe()}")
        mesh = (mesh_for_strategy(strat, device_type=device.type)
                if world else None)
    elif args.pp > 1:
        if cfg.family == "vlm":
            raise SystemExit(
                "--pp does not apply to vlm archs yet: the executable "
                "pipeline engine cannot stage the vision frontend "
                "(train non-pipelined, e.g. --dp, instead)")
        if n_dev < args.pp or n_dev % args.pp:
            raise SystemExit(
                f"--pp {args.pp} needs a device count divisible by the "
                f"stage count; have {n_dev} device(s)")
        dims = {"data": n_dev // args.pp}
        if args.mesh:
            shape, names = mesh_axes(args.mesh)
            dims = dict(zip(names, shape))
            if args.pp * int(np.prod(shape)) != n_dev:
                raise SystemExit(f"--pp {args.pp} x --mesh {args.mesh} "
                                 f"needs {args.pp * int(np.prod(shape))} "
                                 f"ranks; have {n_dev}")
        mp = dims.get("model", 1)
        strat = StrategySpec(dp=dims["data"], tp=mp, pp=args.pp,
                             # whole experts a rank where mp divides
                             # them, else their d_ff (grok's expert TP)
                             ep=(mp if cfg.has_experts
                                 and cfg.n_experts % mp == 0 else 1),
                             micro_batches=args.micro_batches or 1,
                             schedule=args.schedule or "gpipe",
                             zero=args.zero)
        mesh = mesh_for_strategy(strat, device_type=device.type)
    elif not world:
        mesh = None
    elif args.mesh:
        mesh = parse_mesh(args.mesh, device_type=device.type)
    else:                              # the reference's default: all data
        mesh = make_mesh((dist.get_world_size(),), ("data",),
                         device_type=device.type)
    if strat is None and args.zero:
        shape = mesh_shape(mesh) if mesh is not None else {}
        strat = StrategySpec(dp=shape.get("pod", 1) * shape.get("data", 1),
                             tp=shape.get("model", 1), zero=args.zero)
    plan = compile_plan(model, mesh, strategy=strat,
                        compress_pod=args.compress_pod)
    meta = graph.workload_meta()
    predicted = step_cost(meta, plan.strategy, hw)
    if args.auto or args.profile:
        log(f"[plan] {plan.strategy.describe()} on {n_dev} x {hw.name}: "
            f"predicted step {predicted.total:.6g} s (compute "
            f"{predicted.compute:.6g}, comm {predicted.comm:.6g}, bubble "
            f"{predicted.bubble:.6g}; memory {predicted.mem_bytes / 2**30:.2f}"
            f" GiB of {hw.hbm_bytes / 2**30:.2f})")
    pipelined = plan.pipelined
    if pipelined and args.compress_pod:
        raise SystemExit(COMPRESS_PIPE)
    sl = None
    if pipelined and args.stage_layers and model.stack is None:
        raise SystemExit("--stage-layers does not apply to encdec archs: "
                         "the pipeline cut is the fixed encoder|decoder "
                         "tower edge")
    if pipelined:
        sl = (pipe.check_stage_layers(args.stage_layers.split(","),
                                      model.stack.n_rep, plan.strategy.pp)
              if args.stage_layers else plan.stage_layers())
    if plan.sharded or args.auto:
        log(f"[plan] {plan.split_line(sl)}")
    if pipelined and plan.strategy.zero:
        log(f"[plan] zero={plan.strategy.zero} inside a pipeline shards "
            f"nothing over data (the reference's staged specs): it runs as "
            f"zero=0")
    compress = (args.compress_pod and mesh is not None
                and "pod" in mesh.mesh_dim_names)
    if pipelined:
        log(f"[pipeline] {plan.strategy.pp} stages, schedule "
            f"{args.schedule or plan.strategy.schedule}, µb="
            f"{args.micro_batches or plan.strategy.micro_batches}, "
            f"stage_layers {sl}")

    opt = _optimizer(args)
    data = _data_pipeline(args, cfg)
    # a two-tower pipeline's state is replicated: rank 0's is the whole
    two_towers = pipelined and plan.two_towers
    gather = None
    if pipelined and not two_towers:
        gather = lambda tree: plan.gather_pipeline_state(  # noqa: E731
            tree, opt, sl)
    elif plan.sharded:
        gather = lambda tree: plan.gather_state(tree, opt)  # noqa: E731
    ckpt = CheckpointManager(
        args.ckpt_dir, keep=2, rank=rank,
        barrier=dist.barrier if world else None, gather=gather)

    if pipelined:
        params = plan.init_pipeline_params(args.seed, stage_layers=sl)
    else:
        params = plan.init_params(args.seed)
    state = {"params": params, "opt": plan.init_opt(opt, params)}
    if compress:
        state["err"] = grad_compress.init_error_tree(params)
    start_step = 0
    # the error carry is restored with the rest (the reference restores
    # only params and opt, so it cannot resume its own compressed run)
    if pipelined and not two_towers:
        resume = plan.restore_pipeline_state(ckpt, opt, sl)
    elif plan.sharded:
        resume = plan.restore_state(ckpt, opt, with_err=compress)
    else:
        resume = ckpt.restore_latest(state)
    if resume is not None:
        start_step, state, extra = resume
        if "data" in extra:
            data.load_state_dict(extra["data"])
        log(f"[resume] from step {start_step}")

    # exactly-once data (repro/launch/train.py:393-406): a batch is fetched
    # once per step, so a retried step replays the SAME batch, and a save
    # records the position of the committed step
    fetched = {"step": start_step - 1, "batch": None, "before": None}

    def batch_for(i):
        if fetched["step"] != i:
            fetched["before"] = data.state_dict()
            local = plan.batch_slice(data.next_batch())
            fetched["batch"] = {k: torch.as_tensor(np.asarray(v)).to(device)
                                for k, v in local.items()}
            fetched["step"] = i
        return fetched["batch"]

    def data_state_at(s):
        if s == fetched["step"] and fetched["before"] is not None:
            return dict(fetched["before"])     # save at the failed step
        return data.state_dict()

    if pipelined:
        step_fn = plan.pipeline_train_step_fn(
            opt, micro_batches=args.micro_batches, schedule=args.schedule,
            stage_layers=sl)
    else:
        step_fn = plan.train_step_fn(opt, micro_batches=args.micro_batches,
                                     compress_pod=args.compress_pod)
    shape = mesh_shape(mesh) if mesh is not None else None
    n_params = param_count(model.param_shapes())
    log(f"[train] {cfg.name}: {n_params:,} params on "
        f"{device}, mesh {shape}, {plan.strategy.describe()}"
        f"{', int8 cross-pod compression' if compress else ''}, batch "
        f"{args.batch} x {args.seq}, {args.steps} steps")

    losses, step_seconds = [], []
    moe = {"moe_lb": [], "moe_z": []} if cfg.has_experts else None
    monitor = StragglerMonitor()
    profiler = feats = None
    if args.profile:
        # whole-step observations against the executed strategy's
        # features on the --hw table (the reference's driver takes the
        # same, and no others)
        feats = step_cost_features(meta, plan.strategy, hw)
        profiler = Profiler()

    def one_step(i, st):
        t0 = time.perf_counter()
        if "err" in st:
            p, o, m, e = step_fn(st["params"], st["opt"], batch_for(i), i,
                                 st["err"])
            new = {"params": p, "opt": o, "err": e}
        elif two_towers:
            # the encoder's memory ships over the stage wire: the step
            # takes the frames and the tokens
            b = batch_for(i)
            p, o, m = step_fn(st["params"], st["opt"], b["frames"],
                              b["tokens"], i)
            new = {"params": p, "opt": o}
        elif pipelined:
            p, o, m = step_fn(st["params"], st["opt"],
                              batch_for(i)["tokens"], i)
            new = {"params": p, "opt": o}
        else:
            p, o, m = step_fn(st["params"], st["opt"], batch_for(i), i)
            new = {"params": p, "opt": o}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_seconds.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        aux = ""
        if moe is not None:
            for k, vals in moe.items():
                vals.append(float(m[k]))
                aux += f"{k} {vals[-1]:.4f}  "
        if i % args.log_every == 0 or i == args.steps - 1:
            log(f"  step {i:5d}  loss {losses[-1]:.4f}  {aux}"
                f"({step_seconds[-1]:.3f} s)")
        return new

    def on_step(i, st, loop_dt):
        dt = step_seconds[-1]    # the synced step time, not the loop's
        if profiler is not None and i > start_step:
            profiler.record_step(hw.name, dt, feats, step=i)
        if monitor.observe(dt):       # one-shot: True on the flag transition
            log(f"[straggler] flagged at step {i} "
                f"(dt={dt:.3f}s vs mean {monitor.mean:.3f}s)")
            monitor.reset()           # keep training; eviction is external

    loop = FaultTolerantLoop(ckpt, save_every=args.save_every)
    final_step, _ = loop.run(
        state=state, step_fn=one_step, n_steps=args.steps,
        start_step=start_step,
        extra_fn=lambda st, s: {"data": data_state_at(s)},
        on_step=on_step)

    out = {"final_step": final_step, "losses": losses,
           "step_seconds": step_seconds, "mesh": shape,
           "strategy": plan.strategy.describe(),
           "predicted_step_s": predicted.total, **(moe or {})}
    if profiler is not None:
        out["profile"] = prof = profile_summary(profiler, hw, n_dev)
        log(prof["report"])
        log(f"[profile] {hw.name}: {prof['observations']} step "
            f"observations; mean relative prediction error "
            f"{prof['error_before']:.3f} on the table, "
            f"{prof['error_after']:.3f} after the fit")
    loss_str = (f", loss {losses[0]:.4f} → {losses[-1]:.4f}" if losses
                else " (resumed already complete)")
    log(f"[done] step {final_step}{loss_str}")
    return out


if __name__ == "__main__":
    main()
