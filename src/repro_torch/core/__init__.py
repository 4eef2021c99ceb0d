"""Whale core, the port of ``repro/core``: strategy primitives, IR, engine,
cost model, auto-parallel.

The user-facing surface mirrors the paper's API (``import repro_torch as
wh``), under the reference's names (``repro/core/__init__.py``) — all but
``constrain``, the reference's GSPMD layout hint, which the port has no
counterpart of (its collectives are explicit calls of the plan):

    with wh.cluster(mesh_shape=(2, 2), axis_names=("data", "model")):
        with wh.replica():
            h = wh.sub("backbone", net)(params, x)
        with wh.split(dim=-1):
            logits = wh.sub("fc", head)(head_params, h)

The cost model, schedules, heterogeneous balancing, auto-search, the IR
and the graph optimizer are pure Python and numpy, equal to the
reference's; the planner (:mod:`repro_torch.core.planner`) runs its plans
over ``torch.distributed``: data parallelism with cross-pod int8 gradient
compression, the pipeline, a mixed cluster's heterogeneous placement, and
tensor parallelism with ZeRO over the sharding rules
(:mod:`repro_torch.core.sharding`).
"""
from repro_torch.core.auto import (auto_parallel,  # noqa: F401
                                   graph_from_taskgraph, search)
from repro_torch.core.cost_model import (H100_SXM, P100_16G,  # noqa: F401
                                         T4_16G, TPU_V5E, V100_PAPER,
                                         ClusterSpec, DeviceGroup, Hardware,
                                         ModelGraph, SegmentMeta,
                                         StrategySpec, WorkloadMeta,
                                         step_cost, throughput)
from repro_torch.core.graph_opt import (GradAgg, LoweredGraph,  # noqa: F401
                                        StrategyNestingError, bridge_cost,
                                        compile_nested_plan, insert_bridges,
                                        lower, place_grad_aggregation,
                                        plan_bridge, validate_nesting)
from repro_torch.core.hetero import (HeteroPlacement,  # noqa: F401
                                     balance_batch, balance_stages,
                                     hetero_step_cost, plan_placement)
from repro_torch.core.ir import (Bridge, Edge, Subgraph,  # noqa: F401
                                 TaskGraph, TensorMeta, capture_meta)
from repro_torch.core.planner import (ExecutionPlan,  # noqa: F401
                                      compile_plan,
                                      compile_plan_from_cluster,
                                      mesh_for_strategy,
                                      strategy_from_taskgraph)
from repro_torch.core.sharding import (ShardingRules,  # noqa: F401
                                       hybrid_rules, rules_for_strategy,
                                       use_rules)
from repro_torch.core.strategies import (cluster, pipeline,  # noqa: F401
                                         replica, split, stage, sub)
from repro_torch.core.strategies import \
    auto_parallel as auto_scope  # noqa: F401
from repro_torch.core.vdevice import Cluster, VirtualDevice  # noqa: F401
