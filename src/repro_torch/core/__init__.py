"""Whale core, ported slice by slice.  So far: the strategy description
(:class:`~repro_torch.core.cost_model.StrategySpec`) and the planner's
data-parallel path with cross-pod int8 gradient compression
(:mod:`repro_torch.core.planner`)."""
