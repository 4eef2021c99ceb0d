"""Serving driver CLI: continuous batching with a dense or paged KV cache.

Wires :class:`repro_torch.serving.server.Server` to a model with random
weights from ``--seed`` and drives it in one of two modes:

- **batch** (default): all requests available at t=0, drain the queue.
- **--traffic**: open-loop replay of a deterministic heavy-tail arrival
  trace (:mod:`repro_torch.serving.traffic`) against the wall clock, with
  admission control and per-request TTFT/TPOT/e2e accounting
  (:mod:`repro_torch.serving.metrics`).

Over a mesh, as the reference's driver serves: ``--mesh`` lays the ranks
out as ``data × model`` (``DxM``) or ``pod × data × model`` (``PxDxM``),
and the plan :func:`~repro_torch.core.planner.compile_plan` reads off it
(the reference's default strategy: data parallelism over ``pod`` and
``data``, a ``model`` axis split with the vocab) drives a
:class:`~repro_torch.serving.server.Server` whose slots split over the
data axes and whose heads, vocab and KV cache split over ``model``; the
parameters are each rank's blocks (``plan.init_params``).  It serves under
``torchrun``: every rank runs the same loop on the same requests, and rank
0 prints.  A mesh of more than one device outside ``torchrun`` exits
("needs N ranks"); ``--mesh 1x1`` outside it is a world of one over a
``FileStore`` in a temporary directory.  Under ``torchrun`` without
``--mesh`` every rank is a data replica.  Collectives go over NCCL on the
card and gloo on the CPU.

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.

Usage::

    python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --cache paged --requests 16 --batch-slots 8 --prompt-len 500 \
        --gen 64 --max-len 1024

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke \
        --device cpu --traffic --cache paged --requests 16 --rate 4 --gen 8

    python -m repro_torch.launch.serve --arch mamba2-1.3b --cache dense

    python -m repro_torch.launch.serve --arch qwen2-vl-2b --cache paged \
        --requests 8 --batch-slots 8 --prompt-len 256 --gen 32 \
        --max-len 512

    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --cache dense \
        --overrides n_layers=8,param_dtype=bfloat16 --requests 8

    python -m repro_torch.launch.serve --arch deepseek-moe-16b \
        --overrides param_dtype=bfloat16 --cache paged --requests 8

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --smoke --device cpu --mesh 2x2 --cache paged --requests 8 \
        --batch-slots 4 --gen 8 --max-len 64 --overrides n_kv_heads=2

qwen2-vl-2b serves through the Server, paged or dense: text prompts at
M-RoPE positions (the Server passes no patch embeddings, as the
reference's does not; a prompt bucket shorter than the 64-position patch
prefix raises).  seamless-m4t-medium is refused before any weight is
drawn: the reference's Server prefills ``{"tokens"}`` with ``last_idx``,
which its encoder–decoder prefill refuses; an encoder–decoder serves
through ``Model.prefill({"frames": …})`` and ``Model.serve_step``.

``--cache paged`` needs an all-attention arch; with mamba2 or jamba (an
SSD mixer in every period) it raises.  jamba-v0.1-52b's 51.5e9 weights
take 103 GB in bf16, more than one card holds: serve one period of it
(``n_layers=8``, 26.5 GB in bf16).
deepseek-moe-16b at full width wants ``--overrides param_dtype=bfloat16``
(31.44 GiB of weights; in f32 they take 62.9 GiB, and serving casts a
second copy).  Over ``--mesh DxM`` its experts stay whole, E/M a rank,
and each step's combine is all-reduced once over ``model``, as the dense
MLP's::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --smoke --device cpu --mesh 2x2 \
        --cache paged --requests 8 --batch-slots 4 --gen 8 --max-len 64
"""
from __future__ import annotations

import argparse
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, apply_overrides, get_config
from repro_torch.core.planner import compile_plan
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (end_world, make_mesh, mesh_axes,
                                     mesh_shape, parse_mesh, start_world,
                                     under_torchrun)
from repro_torch.models.lm import Model
from repro_torch.serving.metrics import RequestTiming, ServeMetrics
from repro_torch.serving.server import Request, Server
from repro_torch.serving.traffic import TrafficCfg, make_trace


def _sync(server: Server) -> None:
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)


def run_trace(server: Server, params, trace, *, prompt_rng=None,
              vocab: int = 1000) -> ServeMetrics:
    """Open-loop wall-clock replay of ``trace`` against ``server``.

    Arrivals become *ready* at their trace time whether or not the server
    keeps up (queueing shows up in TTFT, as it should).  Ready requests
    admit FIFO while slots are free **and** admission control passes —
    a head-of-line request the page pool can't cover blocks the queue,
    holding its arrival-time ordering.  Preempted requests re-enter at
    the front of the ready queue.
    """
    rng = prompt_rng or np.random.default_rng(1234)
    prompts = {a.rid: rng.integers(0, vocab, a.prompt_len, dtype=np.int32)
               for a in trace}
    arrivals = sorted(trace, key=lambda a: (a.t, a.rid))
    timings = {a.rid: RequestTiming(rid=a.rid, arrival=a.t) for a in trace}
    metrics = ServeMetrics()
    ready: list = []                      # [(Request, arrival_t)]
    t0 = time.time()
    now = lambda: time.time() - t0

    def finish(req, t):
        tm = timings[req.rid]
        tm.finished = t
        tm.n_tokens = len(req.out_tokens)
        tm.preemptions = req.preemptions
        metrics.add(tm)

    while arrivals or ready or server.active:
        t = now()
        while arrivals and arrivals[0].t <= t:
            a = arrivals.pop(0)
            ready.append((Request(a.rid, prompts[a.rid], max_new=a.gen_len),
                          a.t))
        # FIFO admission with head-of-line blocking on the page budget
        while ready and (slot := server.free_slot()) is not None:
            req, _ = ready[0]
            if not server.can_admit(req):
                break
            ready.pop(0)
            server.admit(params, req, slot)   # syncs: reads the first token
            t = now()
            tm = timings[req.rid]
            if tm.admitted is None:        # preempted re-admits keep TTFT
                tm.admitted = tm.first_token = t
            if req.done:
                finish(req, t)
        if server.active:
            for req in server.step(params):
                finish(req, now())
            for req in server.take_requeued():
                ready.insert(0, (req, timings[req.rid].arrival))
        elif ready:
            # empty server that still can't admit the head → it never will
            raise SystemExit(
                f"[serve] request {ready[0][0].rid} can never be admitted "
                f"(prompt {len(ready[0][0].prompt)} + gen "
                f"{ready[0][0].max_new} vs max_len/page budget)")
        elif arrivals:
            time.sleep(min(max(arrivals[0].t - now(), 0.0), 0.05))
    return metrics


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--cache", choices=("dense", "paged"), default="dense")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV rows per page; 0 = the default page size")
    ap.add_argument("--pages", type=int, default=0,
                    help="physical pages in the pool (incl. the trash "
                         "page); 0 = full residency for every slot")
    ap.add_argument("--traffic", action="store_true",
                    help="open-loop Pareto arrival replay with TTFT/TPOT "
                         "accounting instead of the drain-the-queue loop")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="--traffic mean arrival rate (req/s)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x2 = data2 x model2, 1x2x2 = pod1 x data2 x "
                         "model2 (ranks = product; under torchrun)")
    ap.add_argument("--overrides", default="",
                    help="comma k=v LMCfg overrides (e.g. n_kv_heads=2)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def tokens_crc(done: list) -> int:
    """CRC-32 of every request's tokens in request order: one number to
    hold two runs' (or two ranks') token streams equal by."""
    crc = 0
    for req in sorted(done, key=lambda r: r.rid):
        crc = zlib.crc32(np.asarray(req.out_tokens, np.int64).tobytes(), crc)
    return crc


def run(args: argparse.Namespace):
    """Serve as ``args`` say; returns (summary dict, the server).  Over a
    mesh (``--mesh``, or under ``torchrun``) the process group is made
    here and ended before it returns, unless the caller made it."""
    device = resolve_device(args.device)
    if args.mesh and not (under_torchrun() or dist.is_initialized()):
        n = int(np.prod(mesh_axes(args.mesh)[0]))
        if n > 1:
            raise SystemExit(f"--mesh {args.mesh} needs {n} ranks: run it "
                             f"under torchrun --nproc-per-node {n}")
    if not (args.mesh or under_torchrun()) or dist.is_initialized():
        return _serve(args, device)
    with tempfile.TemporaryDirectory() as tmp:
        device, store = start_world(device, tmp)
        try:
            return _serve(args, device)
        finally:
            end_world(store)


ENCDEC_SERVE = ("the {name} encoder–decoder is not served through the "
                "Server: its prefill takes source frames, not the prompt "
                "tokens and last_idx the Server prefills (the reference's "
                "encoder–decoder prefill refuses last_idx); serve it "
                "through Model.prefill({{'frames': ...}}) and "
                "Model.serve_step")


def _serve(args: argparse.Namespace, device: torch.device):
    cfg = apply_overrides(get_config(args.arch, smoke=args.smoke),
                           args.overrides)
    if cfg.family == "encdec":
        raise SystemExit(ENCDEC_SERVE.format(name=cfg.name))
    model = Model(cfg, device=device)
    mesh = None
    if args.mesh:
        mesh = parse_mesh(args.mesh, device_type=device.type)
    elif dist.is_initialized():         # the reference's default: all data
        mesh = make_mesh((dist.get_world_size(),), ("data",),
                         device_type=device.type)
    plan = compile_plan(model, mesh)
    rank = dist.get_rank() if mesh is not None else 0
    log = print if rank == 0 else (lambda *a, **k: None)
    if mesh is not None:
        log(f"[plan] {plan.split_line()}")
    server = Server(model, plan if mesh is not None else None,
                    batch_slots=args.batch_slots, max_len=args.max_len,
                    cache=args.cache, page_size=args.page_size,
                    n_pages=args.pages)
    params = model.serving_params(plan.init_params(args.seed))

    if args.traffic:
        tc = TrafficCfg(rate=args.rate, n_requests=args.requests,
                        prompt_lens=(args.prompt_len,),
                        gen_lens=(args.gen,))
        trace = make_trace(tc, seed=args.seed)
        t0 = time.time()
        metrics = run_trace(server, params, trace,
                            prompt_rng=np.random.default_rng(args.seed),
                            vocab=cfg.vocab)
        _sync(server)
        dt = time.time() - t0
        s = metrics.summary()
        if s["completed"] != args.requests:
            raise SystemExit(
                f"[serve] BUG: {s['completed']}/{args.requests} requests "
                f"completed under traffic replay")
        log(f"[serve/{args.cache}] traffic: {s['completed']} requests, "
            f"{s['tokens']} tokens in {dt:.2f}s — "
            f"{s['tokens_per_s']:.1f} tok/s, "
            f"ttft p50/p99 {s['ttft_p50_s'] * 1e3:.0f}/"
            f"{s['ttft_p99_s'] * 1e3:.0f} ms, "
            f"tpot {s['tpot_mean_s'] * 1e3:.1f} ms, "
            f"{s['preemptions']} preemptions, "
            f"{server.prefill_cache_size} prefill buckets")
        s["steps"] = server.steps
        s["seconds"] = dt
        return s, server

    rng = np.random.default_rng(args.seed)
    pending = [Request(i, rng.integers(0, cfg.vocab, args.prompt_len,
                                       dtype=np.int32), max_new=args.gen)
               for i in range(args.requests)]

    t0 = time.time()
    done: list = []
    while pending or server.active:
        while (pending and (slot := server.free_slot()) is not None
               and server.can_admit(pending[0])):
            req = pending.pop(0)
            server.admit(params, req, slot)
            if req.done:                      # finished at admission
                done.append(req)
        if pending and not server.active:
            raise SystemExit(
                f"[serve] request {pending[0].rid} can never be admitted "
                f"(prompt {len(pending[0].prompt)} + gen "
                f"{pending[0].max_new} vs max_len {args.max_len} / page "
                f"budget)")
        done.extend(server.step(params))
        pending[:0] = server.take_requeued()  # preempted restart first
    _sync(server)
    dt = time.time() - t0
    if len(done) != args.requests:
        raise SystemExit(
            f"[serve] BUG: {len(done)}/{args.requests} requests completed "
            f"— finished requests were dropped")
    total_toks = sum(len(r.out_tokens) for r in done)
    crc = tokens_crc(done)
    log(f"[serve/{args.cache}] {args.requests} requests completed, "
        f"{total_toks} tokens in {dt:.2f}s ({total_toks / dt:.1f} tok/s, "
        f"{server.steps} decode steps, "
        f"{server.prefill_cache_size} prefill buckets, tokens crc32 "
        f"{crc:08x})")
    return {"steps": server.steps, "seconds": dt,
            "completed": len(done), "tokens": total_toks,
            "tokens_crc32": crc,
            "out_tokens": {r.rid: list(map(int, r.out_tokens))
                           for r in done},
            "preemptions": sum(r.preemptions for r in done),
            "mesh": mesh_shape(mesh) if mesh is not None else None}, server


def main(argv=None) -> dict:
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
