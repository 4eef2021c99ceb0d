"""The port's sharding rules (``repro_torch.core.sharding``) and the
plan's specs against the reference's ``ShardingRules`` (``repro``), with
``==``.

The reference's plans are compiled on ``jax.sharding.AbstractMesh``,
which needs no devices; the port's ``ExecutionPlan`` takes the same rules
without a process group.  Every tinyllama-1.1b leaf at its full-size
shape, over the meshes model 2/4/8/16, data×model 2×2 and 4×2 and
pod×data×model 2×2×2, with zero 0/1/3 and vocab_split on and off: the
parameter specs, AdamW's and adafactor's state specs, and the attention
layout the rules choose.  Then the leaf-level helpers on a world of one
rank: a leaf cut by its spec and the mixed-radix block order of a spec
over two axes.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.core import planner as ref_planner
from repro.core import sharding as ref_sharding
from repro.core.cost_model import StrategySpec as RefStrategySpec
from repro.models import attention as ref_attn
from repro.models import lm as ref_lm
from repro.optim import optimizer as ref_opt
from repro_torch.configs import get_config
from repro_torch.core import planner, sharding
from repro_torch.core.cost_model import StrategySpec
from repro_torch.models import attention
from repro_torch.models.lm import Model
from repro_torch.optim import optimizer

ARCH = "tinyllama-1.1b"
#: name: (axis sizes, axis names)
MESHES = {"model2": ((1, 2), ("data", "model")),
          "model4": ((1, 4), ("data", "model")),
          "model8": ((1, 8), ("data", "model")),
          "model16": ((1, 16), ("data", "model")),
          "data2_model2": ((2, 2), ("data", "model")),
          "data4_model2": ((4, 2), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
CASES = list(itertools.product(MESHES, (0, 1, 3), (True, False)))


def _strategy(shape: dict, zero: int, vocab_split: bool) -> dict:
    return dict(dp=shape.get("pod", 1) * shape["data"], tp=shape["model"],
                zero=zero, vocab_split=vocab_split)


def _specs(tree):
    """A tree of specs (the reference's ``PartitionSpec``s or the port's
    tuples) as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.fixture(scope="module")
def models():
    return (ref_lm.build(jax_get_config(ARCH)), Model(get_config(ARCH),
                                                      "meta"))


def _plans(models, name, zero, vs):
    sizes, axes = MESHES[name]
    shape = dict(zip(axes, sizes))
    kw = _strategy(shape, zero, vs)
    ref = ref_planner.compile_plan(models[0], AbstractMesh(sizes, axes),
                                   RefStrategySpec(**kw))
    strat = StrategySpec(**kw)
    ours = planner.ExecutionPlan(
        model=models[1], mesh=None, strategy=strat,
        rules=sharding.rules_for_strategy(shape, strat))
    return ref, ours


@pytest.mark.parametrize("name,zero,vocab_split", CASES)
def test_param_and_opt_specs_match_reference(models, name, zero,
                                             vocab_split):
    """AdamW's state as the ranks hold it is the reference's
    ``opt_specs``; so is Adafactor's without ZeRO.  Under ZeRO each rank
    holds the factored moments of the block it updates (the reference's
    parameter specs with the ZeRO extension), their means all-reduced
    over the dim each averages."""
    ref, ours = _plans(models, name, zero, vocab_split)
    assert ours.rules.rules == ref.rules.rules
    assert _specs(ours.param_specs) == _specs(ref.param_specs)
    assert _specs(ours.state_layout(optimizer.adamw())) == \
        _specs(ref.opt_specs(ref_opt.adamw()))
    if zero == 0:
        want = ref.opt_specs(ref_opt.adafactor())
    else:
        blocks = ref.rules.param_specs_tree(ref.param_axes,
                                            ref.param_shapes, fsdp=True)
        want = {"v": jax.tree.map(
            lambda s: ({"vr": s[:-1], "vc": s[:-2] + s[-1:]}
                       if len(s) >= 2 else {"v": s}), _specs(blocks),
            is_leaf=lambda x: isinstance(x, tuple))}
    assert _specs(ours.state_layout(optimizer.adafactor())) == _specs(want)


@pytest.mark.parametrize("name", list(MESHES))
def test_attention_layout_matches_reference(models, name):
    """grouped where the 4 kv heads divide the model axis, repeat where
    only the 32 q heads do (model 8 and 16)."""
    ref, ours = _plans(models, name, 0, True)
    jcfg = jax_get_config(ARCH)
    ref_cfg = ref_attn.AttnCfg(d_model=jcfg.d_model, n_heads=jcfg.n_heads,
                               n_kv_heads=jcfg.n_kv_heads,
                               head_dim=jcfg.head_dim)
    with ref_sharding.use_rules(ref.rules):
        want = ref_attn.choose_layout(ref_cfg)
    with sharding.use_rules(ours.rules):
        got = attention.choose_layout(get_config(ARCH).attn_cfg())
    assert got == want
    assert got == ("grouped" if MESHES[name][0][-1] <= 4 else "repeat")
    # a config neither head count divides takes the seq layout
    odd = dataclasses.replace(get_config(ARCH).attn_cfg(), n_heads=12,
                              n_kv_heads=4)
    with sharding.use_rules(ours.rules):
        assert attention.choose_layout(odd) == (
            "seq" if MESHES[name][0][-1] in (8, 16) else "grouped"
            if MESHES[name][0][-1] in (2, 4) else "repeat")


@pytest.mark.parametrize("names,shape", [
    (("embed", "q_heads", "head_dim"), (2048, 32, 64)),
    (("embed", "kv_heads", "head_dim"), (2048, 4, 64)),
    (("vocab", "embed"), (32000, 2048)),
    (("layers", "embed", "mlp"), (22, 2048, 5632)),
    (("q_heads", "kv_heads"), (32, 4)),
    ((None, "batch", "fsdp"), (7, 8, 64))])
def test_spec_for_and_param_spec_match_reference(names, shape):
    """Pruning, first come wins and the FSDP extension, leaf by leaf."""
    for (sizes, axes), fsdp in itertools.product(MESHES.values(),
                                                 (True, False)):
        ref = ref_sharding.hybrid_rules(AbstractMesh(sizes, axes),
                                        fsdp=fsdp)
        ours = sharding.hybrid_rules(dict(zip(axes, sizes)), fsdp=fsdp)
        assert ours.spec_for(names, shape) == tuple(ref.spec_for(names,
                                                                 shape))
        assert ours.spec_for(names) == tuple(ref.spec_for(names))
        for fa in ((), ("pod", "data"), ("data",)):
            assert ours.param_spec(names, shape, fsdp_axes=fa) == tuple(
                ref.param_spec(names, shape, fsdp_axes=fa))


class _Mesh:
    """A stand-in for a DeviceMesh: this rank's coordinate per axis."""

    def __init__(self, coords: dict):
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


def test_shard_leaf_cuts_the_spec_blocks_in_mixed_radix_order():
    """A spec over ("pod", "data") deals blocks pod-major, as the
    reference's PartitionSpec does; each rank's blocks tile the leaf."""
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    shape = {"pod": 2, "data": 2, "model": 3}
    spec = (("pod", "data"), "model")
    seen = np.zeros((8, 6), int)
    for pod, data, model in itertools.product(range(2), range(2), range(3)):
        rules = sharding.ShardingRules(shape=shape, mesh=_Mesh(
            {"pod": pod, "data": data, "model": model}))
        block = sharding.shard_leaf(full, spec, rules)
        assert block.shape == (2, 2)
        r0, c0 = (2 * pod + data) * 2, model * 2
        assert torch.equal(block, full[r0:r0 + 2, c0:c0 + 2])
        seen[r0:r0 + 2, c0:c0 + 2] += 1
    assert (seen == 1).all()
    # a replicated spec hands the leaf back as it is
    rules = sharding.ShardingRules(shape=shape, mesh=_Mesh(
        {"pod": 1, "data": 1, "model": 2}))
    assert sharding.shard_leaf(full, (None, None), rules) is full
