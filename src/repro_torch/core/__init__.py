"""Whale core, ported slice by slice: the cost model, pipeline schedules,
heterogeneous balancing, the auto-search and calibration (pure Python and
numpy, equal to the reference's bit for bit), and the planner
(:mod:`repro_torch.core.planner`): data parallelism with cross-pod int8
gradient compression, the pipeline, a mixed cluster's heterogeneous
placement (uneven stage layers and batch shares), and tensor parallelism
with ZeRO over the sharding rules (:mod:`repro_torch.core.sharding`).
Exported under the reference's names (``repro/core/__init__.py``) as far
as they are ported."""
from repro_torch.core.auto import auto_parallel, search  # noqa: F401
from repro_torch.core.cost_model import (H100_SXM, P100_16G,  # noqa: F401
                                         T4_16G, TPU_V5E, V100_PAPER,
                                         ClusterSpec, DeviceGroup, Hardware,
                                         ModelGraph, SegmentMeta,
                                         StrategySpec, WorkloadMeta,
                                         step_cost, throughput)
from repro_torch.core.hetero import (HeteroPlacement,  # noqa: F401
                                     balance_batch, balance_stages,
                                     hetero_step_cost, plan_placement)
from repro_torch.core.planner import (ExecutionPlan,  # noqa: F401
                                      compile_plan, mesh_for_strategy)
from repro_torch.core.sharding import (ShardingRules,  # noqa: F401
                                       hybrid_rules, rules_for_strategy,
                                       use_rules)
