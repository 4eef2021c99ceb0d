"""The port's layers (``repro_torch.models.layers``) against the reference
(``repro.models.layers``): the same numpy inputs through both.

Tolerances follow the reference's policy (tests/kernel_harness.py): f32
2e-5, bf16 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as jl
from repro.models.lm import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models.convert import leaf_paths
from repro_torch.models.lm import Model

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _np(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matches_reference(dtype):
    x, scale = _np((2, 5, 64), (64,))
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, dtype))
    got = tl.rmsnorm({"scale": torch.tensor(scale)},
                     torch.tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_matches_reference(dtype):
    (x,) = _np((2, 7, 4, 32), seed=1)
    positions = np.random.default_rng(2).integers(0, 900, (2, 7))
    want = jl.apply_rope(jnp.asarray(x, dtype), jnp.asarray(positions), 1e4)
    got = tl.apply_rope(torch.tensor(x).to(getattr(torch, dtype)),
                        torch.tensor(positions), 1e4)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_mlp_matches_reference(dtype):
    x, wi, wg, wo = _np((2, 3, 64), (64, 96), (64, 96), (96, 64), seed=3)
    wi, wg, wo = wi / 8, wg / 8, wo / 10
    want = jl.mlp({"wi": jnp.asarray(wi), "wg": jnp.asarray(wg),
                   "wo": jnp.asarray(wo)}, jnp.asarray(x, dtype))
    got = tl.mlp({"wi": torch.tensor(wi), "wg": torch.tensor(wg),
                  "wo": torch.tensor(wo)},
                 torch.tensor(x).to(getattr(torch, dtype)))
    _close(got, want, dtype)


def test_embed_and_pad_vocab_match_reference():
    (table,) = _np((40, 16), seed=4)
    tokens = np.array([[0, 3, 39], [7, 7, 1]])
    want = jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens))
    got = tl.embed({"table": torch.tensor(table)}, torch.tensor(tokens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for v, m in ((32000, 256), (512, 16), (500, 16), (1, 8)):
        assert tl.pad_vocab(v, m) == jl.pad_vocab(v, m)


@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_reference(smoke):
    """Every field the port keeps has the reference's value."""
    ours = get_config("tinyllama-1.1b", smoke=smoke)
    ref = jax_config("tinyllama-1.1b", smoke=smoke)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert ours.padded_vocab == ref.padded_vocab


def test_init_matches_reference_in_distribution():
    """Same leaves, shapes and dtypes as the reference's ``Model.init``;
    each leaf's mean and std agree (the draws differ: JAX and PyTorch
    generators give different numbers from one seed)."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    ours = leaf_paths(Model(cfg, device="cpu").init(0))
    from repro.ckpt.checkpoint import _leaf_paths
    jtree = JaxModel(jax_config("tinyllama-1.1b", smoke=True)).init(
        jax.random.key(0))
    ref = dict(zip(_leaf_paths(jtree), jax.tree.leaves(jtree)))
    assert set(ours) == set(ref)
    for path, t in ours.items():
        r = np.asarray(ref[path])
        assert tuple(t.shape) == r.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), path
        a = t.numpy()
        assert abs(a.mean() - r.mean()) < 0.05 * max(r.std(), 1e-3) + 1e-6, \
            path
        if r.std() > 0:
            assert abs(a.std() / r.std() - 1) < 0.05, path
        else:
            np.testing.assert_array_equal(a, r)
