"""Training driver (CLI).

config → model → Whale plan (mesh) → optimizer → data pipeline → train
step → fault-tolerant loop with checkpoints and auto-resume, as
``repro/launch/train.py``.  ``--mesh`` lays the ranks out as the
reference reads it (``data``, ``data × model``, ``pod × data × model``);
the plan trains data-parallel over ``pod`` and ``data``, and
``--compress-pod`` sends the cross-pod gradient reduction through the
int8 error-feedback compressor (``optim/grad_compress.py``, the quant
kernels).  The flags of later slices (``--pp``, a ``model`` dim above 1)
are refused with a message naming the slice; ``--auto``, ``--schedule``,
``--stage-layers``, ``--hosts``, the fault injections and ``--profile``
are not accepted.

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

    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \
        --device cpu --steps 3 --batch 2 --seq 32 --ckpt-dir "$TMPDIR/ck"
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.planner import PP_SLICE, TP_SLICE, compile_plan
from repro_torch.data.pipeline import DataCfg, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (make_mesh, mesh_axes, mesh_shape,
                                     parse_mesh)
from repro_torch.models.lm import Model, param_count
from repro_torch.optim import grad_compress
from repro_torch.optim.optimizer import Schedule, adafactor, adamw
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop


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
    ap.add_argument("--micro-batches", type=int, default=1,
                    help="sequential gradient accumulation over M slices")
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
    ap.add_argument("--distributed", action="store_true",
                    help="require a torchrun world (RANK, WORLD_SIZE, "
                         "MASTER_ADDR, MASTER_PORT in the environment)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: only 1 in this slice")
    return ap.parse_args(argv)


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _refuse_later_slices(args) -> None:
    """Flags of slices not ported yet exit with a message naming them."""
    if args.pp > 1:
        raise SystemExit(f"--pp {args.pp}: {PP_SLICE}")
    if args.mesh:
        shape, axes = mesh_axes(args.mesh)
        model = dict(zip(axes, shape)).get("model", 1)
        if model > 1:
            raise SystemExit(f"--mesh {args.mesh} has a model dim of "
                             f"{model}: {TP_SLICE}")


def _start_world(args, device: torch.device):
    """(device, FileStore path or None) after making the default process
    group where this run needs one and none exists: under torchrun from
    its environment, else a world of one over a FileStore in the
    checkpoint directory.  Returns (device, None) when the group was made
    by the caller, and no group at all without --mesh outside torchrun."""
    if dist.is_initialized():
        return device, None
    torchrun = _under_torchrun()
    if args.distributed and not torchrun:
        raise SystemExit("--distributed needs a torchrun world: RANK, "
                         "WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the "
                         "environment")
    if not (torchrun or args.mesh):
        return device, None
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and torchrun:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.index is not None:
        torch.cuda.set_device(device)
    if torchrun:
        dist.init_process_group(backend)
        return device, ""
    os.makedirs(args.ckpt_dir, exist_ok=True)
    path = os.path.join(args.ckpt_dir,
                        f".filestore_{os.getpid()}_{time.time_ns()}")
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    return device, path


def _apply_overrides(cfg, spec: str):
    if not spec:
        return cfg
    kv = {}
    for pair in spec.split(","):
        k, v = pair.split("=")
        cur = getattr(cfg, k)
        kv[k] = type(cur)(v) if not isinstance(cur, bool) else v == "True"
    return dataclasses.replace(cfg, **kv)


def main(argv=None) -> dict:
    """Train; returns {"final_step", "losses", "step_seconds", "mesh"}
    (each step's wall time, ending after the device finished the step;
    the mesh's {axis: size}, or None for one device without a process
    group)."""
    args = parse_args(argv)
    _refuse_later_slices(args)
    device, store = _start_world(args, resolve_device(args.device))
    try:
        return _train(args, device)
    finally:
        if store is not None:
            dist.destroy_process_group()
        if store:
            try:
                os.remove(store)
            except FileNotFoundError:
                pass


def _train(args, device: torch.device) -> dict:
    cfg = _apply_overrides(get_config(args.arch, smoke=args.smoke),
                           args.overrides)
    model = Model(cfg, device)
    world = dist.is_initialized()
    rank = dist.get_rank() if world else 0
    log = (lambda *a: print(*a, flush=True)) if rank == 0 else \
        (lambda *a: None)
    if not world:
        mesh = None
    elif args.mesh:
        mesh = parse_mesh(args.mesh, device_type=device.type)
    else:                              # the reference's default: all data
        mesh = make_mesh((dist.get_world_size(),), ("data",),
                         device_type=device.type)
    plan = compile_plan(model, mesh)
    compress = (args.compress_pod and mesh is not None
                and "pod" in mesh.mesh_dim_names)

    sched = Schedule(base_lr=args.lr, warmup=min(100, args.steps // 10 + 1),
                     decay_steps=args.steps)
    opt = (adamw(lr=sched) if args.optimizer == "adamw"
           else adafactor(lr=sched))
    # every rank draws the same global batch (one stream, as the
    # reference's) and trains on its rows of it
    data = TokenPipeline(DataCfg(global_batch=args.batch, seq_len=args.seq,
                                 vocab=cfg.vocab, seed=args.seed),
                         host_id=0, n_hosts=1)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2, rank=rank,
                             barrier=dist.barrier if world else None)

    params = plan.init_params(args.seed)
    state = {"params": params, "opt": opt.init(params)}
    if compress:
        state["err"] = grad_compress.init_error_tree(params)
    start_step = 0
    # the error carry is restored with the rest (the reference restores
    # only params and opt, so it cannot resume its own compressed run)
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

    step_fn = plan.train_step_fn(opt, micro_batches=args.micro_batches,
                                 compress_pod=args.compress_pod)
    shape = mesh_shape(mesh) if mesh is not None else None
    log(f"[train] {cfg.name}: {param_count(state['params']):,} params on "
        f"{device}, mesh {shape}, {plan.strategy.describe()}"
        f"{', int8 cross-pod compression' if compress else ''}, batch "
        f"{args.batch} x {args.seq}, {args.steps} steps")

    losses, step_seconds = [], []

    def one_step(i, st):
        t0 = time.perf_counter()
        if "err" in st:
            p, o, m, e = step_fn(st["params"], st["opt"], batch_for(i), i,
                                 st["err"])
            new = {"params": p, "opt": o, "err": e}
        else:
            p, o, m = step_fn(st["params"], st["opt"], batch_for(i), i)
            new = {"params": p, "opt": o}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_seconds.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            log(f"  step {i:5d}  loss {losses[-1]:.4f}  "
                f"({step_seconds[-1]:.3f} s)")
        return new

    loop = FaultTolerantLoop(ckpt, save_every=args.save_every)
    final_step, _ = loop.run(
        state=state, step_fn=one_step, n_steps=args.steps,
        start_step=start_step,
        extra_fn=lambda st, s: {"data": data_state_at(s)})

    loss_str = (f", loss {losses[0]:.4f} → {losses[-1]:.4f}" if losses
                else " (resumed already complete)")
    log(f"[done] step {final_step}{loss_str}")
    return {"final_step": final_step, "losses": losses,
            "step_seconds": step_seconds, "mesh": shape}


if __name__ == "__main__":
    main()
