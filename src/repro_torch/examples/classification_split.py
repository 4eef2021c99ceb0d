"""Paper Case 2 / §3.2 — large-scale classification with DP + operator
split, on the port.

A ResNet-style feature extractor is replicated (data parallel) while the
large FC + softmax head is split over the ``model`` axis — the hybrid that
gave Whale its 14.8× over pure DP (Fig 5).  The backbone is an MLP
stand-in (the paper's point is the *strategy*, not the conv stack) and the
class count is scaled down::

    PYTHONPATH=src python -m repro_torch.examples.classification_split

(``--device cpu`` on the CPU).  The scopes record the TaskGraph; the graph
optimizer derives the strategy and lowers it (the replicate → split edge
gets its all-gather bridge).  The port executes a split through the plans
it compiles for its language models (``compile_nested_plan``); ``wh.sub``
runs the function it wraps as it is, so the steps here train the
classifier on this process's device, and the fig-5 headline comes from
the cost model at the paper's scale.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch as wh
from repro_torch.core.cost_model import (V100_PAPER, ModelGraph, SegmentMeta,
                                         StrategySpec, step_cost)
from repro_torch.device import resolve_device

N_CLASSES = 10_000
D_FEAT = 256
BATCH = 32


def backbone(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w in params["layers"]:
        h = torch.relu(h @ w)
    return h


def fc_head(params: dict, feats: torch.Tensor) -> torch.Tensor:
    return feats @ params["w"]                 # (B, N_CLASSES)


def loss_fn(params: dict, x: torch.Tensor, labels: torch.Tensor):
    # Case 2: replica around the backbone, split around the head.
    with wh.replica():
        feats = wh.sub("backbone", backbone)(params["backbone"], x)
    with wh.split(dim=-1):
        logits = wh.sub("fc", fc_head)(params["head"], feats)
    return torch.nn.functional.cross_entropy(logits.float(), labels)


def fig5_headline() -> tuple:
    """DP against DP × split on 64 of the paper's V100s: (ms a step each,
    the speedup), from the cost model."""
    meta = ModelGraph(
        name="resnet50-100k",
        segments=(SegmentMeta(name="resnet50", n_layers=50,
                              fwd_flops=2 * 4e9 * 256,
                              param_bytes=90e6 * 4,
                              act_bytes_per_layer=256 * 2048 * 4),),
        batch=256, extra_param_bytes=782e6 * 4,
        logits_bytes=256 * 100_000 * 4, head_param_bytes=782e6 * 4,
        tp_shardable_fraction=782e6 / (90e6 + 782e6)).workload_meta()
    dp = step_cost(meta, StrategySpec(dp=64, vocab_split=False), V100_PAPER)
    hy = step_cost(meta, StrategySpec(dp=16, tp=4, vocab_split=True),
                   V100_PAPER)
    return dp.total * 1e3, hy.total * 1e3, dp.total / hy.total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    params = {
        "backbone": {"layers": [
            (torch.randn(D_FEAT, D_FEAT, generator=gen) * 0.05).to(dev)
            for _ in range(4)]},
        "head": {"w": (torch.randn(D_FEAT, N_CLASSES, generator=gen)
                       * 0.05).to(dev)},
    }
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(BATCH, D_FEAT)),
                        dtype=torch.float32).to(dev)
    labels = torch.as_tensor(rng.integers(0, N_CLASSES, BATCH)).to(dev)

    cluster = wh.cluster(mesh_shape=(1, 1), axis_names=("data", "model"),
                         device_type=dev.type)
    leaves = params["backbone"]["layers"] + [params["head"]["w"]]
    for p in leaves:
        p.requires_grad_(True)
    try:
        with cluster:
            for i in range(args.steps):
                # step 0 records the TaskGraph; later steps replay its
                # names in order and record nothing more
                loss = loss_fn(params, x, labels)
                grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    for p, g in zip(leaves, grads):
                        p -= 0.5 * g
                print(f"  step {i} loss {float(loss):.4f}")
        lowered = wh.lower(cluster)
        print(f"[case 2] {len(cluster.taskgraph.nodes)} subgraphs recorded "
              f"over {args.steps} steps; inferred strategy: "
              f"{wh.strategy_from_taskgraph(cluster).describe()}; lowered: "
              f"{lowered.describe()}")
    finally:
        cluster.close()

    dp_ms, hy_ms, speedup = fig5_headline()
    print(f"[fig5 headline] 64-GPU DP: {dp_ms:.0f} ms/step; DP×split: "
          f"{hy_ms:.0f} ms/step; speedup {speedup:.1f}×")
    print("classification_split OK")


if __name__ == "__main__":
    main()
