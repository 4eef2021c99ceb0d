"""Single-device training driver (CLI).

config → model → optimizer → data pipeline → train step → fault-tolerant
loop with checkpoints and auto-resume: the unmeshed path of
``repro/launch/train.py``.  The meshed and multi-host flags of the
reference (``--mesh``, ``--pp``, ``--auto``, ``--hosts``, the fault
injections, ``--profile``, …) come with the engine and elastic slices and
are not accepted here.

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.

Usage::

    python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --batch 4 --seq 2048 --steps 8 --ckpt-dir /path/to/ckpt

    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \
        --device cpu --steps 3 --batch 2 --seq 32 --ckpt-dir "$TMPDIR/ck"
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.pipeline import DataCfg, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.lm import Model, param_count
from repro_torch.optim.optimizer import Schedule, adafactor, adamw
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop
from repro_torch.tree import flatten, unflatten


def check_micro_divides(batch: int, micro_batches: int) -> int:
    """The ``B % M != 0`` guard (``repro/core/pipeline.py``): a truncated
    split would silently drop the trailing ``B % M`` sequences."""
    if micro_batches < 1:
        raise ValueError(f"micro_batches must be >= 1, got {micro_batches}")
    if batch % micro_batches:
        raise ValueError(
            f"global batch {batch} is not divisible by micro_batches="
            f"{micro_batches}; pick M dividing B (or pad the batch)")
    return batch // micro_batches


def loss_and_grads(model: Model, params: dict, batch: dict):
    """(loss, metrics, grads): the loss of one batch and its gradient with
    respect to every parameter leaf, as a tree shaped like ``params``."""
    paths, leaves = flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(paths, list(grads))


def make_train_step(model: Model, optimizer, micro_batches: int = 1):
    """The unmeshed body of ``ExecutionPlan.train_step_fn``
    (``repro/core/planner.py:246-301``): loss and grads, summed
    sequentially over ``micro_batches`` equal slices of the batch and
    averaged (a batch they do not divide raises), then
    ``optimizer.apply``.  Returns ``step_fn(params, opt_state, batch,
    step) -> (params, opt_state, metrics)``; the optimizer updates in
    place."""
    M = micro_batches

    def accumulate(params, batch):
        if M <= 1:
            return loss_and_grads(model, params, batch)
        mb = check_micro_divides(batch["tokens"].shape[0], M)
        acc = None
        loss_sum, mets = 0.0, []
        for i in range(M):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics, g = loss_and_grads(model, params, micro)
            g = flatten(g)[1]
            acc = ([x.float() for x in g] if acc is None
                   else [a + x for a, x in zip(acc, g)])
            loss_sum = loss_sum + loss
            mets.append(metrics)
        paths = flatten(params)[0]
        grads = unflatten(paths, [a / M for a in acc])
        metrics = {k: torch.stack([m[k] for m in mets]).mean(0)
                   for k in mets[0]}
        return loss_sum / M, metrics, grads

    def step_fn(params, opt_state, batch, step):
        loss, metrics, grads = accumulate(params, batch)
        params, opt_state = optimizer.apply(grads, opt_state, params, step)
        return params, opt_state, dict(metrics, loss=loss)

    return step_fn


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
    return ap.parse_args(argv)


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
    """Train; returns {"final_step", "losses", "step_seconds"} (each step's
    wall time, ending after the device finished the step)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = _apply_overrides(get_config(args.arch, smoke=args.smoke),
                           args.overrides)
    model = Model(cfg, device)

    sched = Schedule(base_lr=args.lr, warmup=min(100, args.steps // 10 + 1),
                     decay_steps=args.steps)
    opt = (adamw(lr=sched) if args.optimizer == "adamw"
           else adafactor(lr=sched))
    data = TokenPipeline(DataCfg(global_batch=args.batch, seq_len=args.seq,
                                 vocab=cfg.vocab, seed=args.seed))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    params = model.init(args.seed)
    opt_state = opt.init(params)
    start_step = 0
    resume = ckpt.restore_latest({"params": params, "opt": opt_state})
    if resume is not None:
        start_step, tree, extra = resume
        params, opt_state = tree["params"], tree["opt"]
        if "data" in extra:
            data.load_state_dict(extra["data"])
        print(f"[resume] from step {start_step}", flush=True)

    # exactly-once data (repro/launch/train.py:393-406): a batch is fetched
    # once per step, so a retried step replays the SAME batch, and a save
    # records the position of the committed step
    fetched = {"step": start_step - 1, "batch": None, "before": None}

    def batch_for(i):
        if fetched["step"] != i:
            fetched["before"] = data.state_dict()
            fetched["batch"] = {k: torch.as_tensor(np.asarray(v)).to(device)
                                for k, v in data.next_batch().items()}
            fetched["step"] = i
        return fetched["batch"]

    def data_state_at(s):
        if s == fetched["step"] and fetched["before"] is not None:
            return dict(fetched["before"])     # save at the failed step
        return data.state_dict()

    step_fn = make_train_step(model, opt, args.micro_batches)
    print(f"[train] {cfg.name}: {param_count(params):,} params on {device}, "
          f"batch {args.batch} x {args.seq}, {args.steps} steps", flush=True)

    losses, step_seconds = [], []

    def one_step(i, st):
        t0 = time.perf_counter()
        p, o, m = step_fn(st["params"], st["opt"], batch_for(i), i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_seconds.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"  step {i:5d}  loss {losses[-1]:.4f}  "
                  f"({step_seconds[-1]:.3f} s)", flush=True)
        return {"params": p, "opt": o}

    loop = FaultTolerantLoop(ckpt, save_every=args.save_every)
    final_step, _ = loop.run(
        state={"params": params, "opt": opt_state}, step_fn=one_step,
        n_steps=args.steps, start_step=start_step,
        extra_fn=lambda st, s: {"data": data_state_at(s)})

    loss_str = (f", loss {losses[0]:.4f} → {losses[-1]:.4f}" if losses
                else " (resumed already complete)")
    print(f"[done] step {final_step}{loss_str}", flush=True)
    return {"final_step": final_step, "losses": losses,
            "step_seconds": step_seconds}


if __name__ == "__main__":
    main()
