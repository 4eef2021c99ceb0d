"""Quickstart — the paper's Case 1 (pure data parallelism) plus the engine,
on the port.

One process (a world of one that ``wh.cluster`` starts), on the card::

    PYTHONPATH=src python -m repro_torch.examples.quickstart

on the CPU: add ``--device cpu``; over several ranks, under ``torchrun``
(the cluster then spans the world along ``data``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import repro_torch as wh
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import under_torchrun
from repro_torch.models.lm import Model
from repro_torch.optim.optimizer import adamw


def tiny_net(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"])
    return h @ params["w2"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and under_torchrun():      # one card a rank
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)

    # ---- Case 1: a replica scope around an arbitrary model function -----
    # wh.cluster owns the device mesh; wh.replica() marks the enclosed
    # subgraph for data parallelism; wh.sub records it in the Whale IR.
    gen = torch.Generator().manual_seed(0)
    params = {"w1": (torch.randn(32, 64, generator=gen) * 0.1).to(dev),
              "w2": (torch.randn(64, 8, generator=gen) * 0.1).to(dev)}
    x = torch.randn(16, 32, generator=gen).to(dev)
    cl = wh.cluster(device_type=dev.type)          # the mesh over the world
    try:
        with cl:
            with wh.replica():
                out = wh.sub("net", tiny_net)(params, x)
        print(f"[case 1] out {tuple(out.shape)}; recorded "
              f"{len(cl.taskgraph.nodes)} subgraph(s): "
              f"{[n.name for n in cl.taskgraph.nodes]}, "
              f"flops={cl.taskgraph.nodes[0].flops:,}; mesh {cl.shape}")

        # ---- the engine on a real architecture --------------------------
        cfg = get_config("tinyllama-1.1b", smoke=True)
        model = Model(cfg, dev)
        plan = wh.compile_plan_from_cluster(cl, model)
        print(f"[engine] {plan.strategy.describe()} from the recorded "
              f"scopes")
        opt = adamw(lr=1e-3)
        params = plan.init_params(0)
        opt_state = plan.init_opt(opt, params)
        step = plan.train_step_fn(opt)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (8, 128)), dtype=torch.int32)
        batch = plan.batch_slice({"tokens": tokens.to(dev)})
        for i in range(args.steps):
            params, opt_state, m = step(params, opt_state, batch, i)
            print(f"[engine] step {i} loss {float(m['loss']):.4f}")
    finally:
        cl.close()
    print("quickstart OK")


if __name__ == "__main__":
    main()
