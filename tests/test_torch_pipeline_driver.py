"""The training driver's pipeline (``--pp --schedule --stage-layers``)
under ``torchrun`` on 4 gloo ranks (``stage 2 × data 2``) against the
reference on the CPU: its losses against the reference's unpipelined
loop, a resume from its uneven checkpoint against a straight run, and that
checkpoint restored by the reference's ``CheckpointManager`` into
``pipeline_params``' padded layout.

The reference's own pipelined driver does not run on this jax
(tests/test_distributed.py), so its unpipelined loop is composed from the
unmeshed pieces, as tests/test_torch_train.py composes it: ``value_and_grad
(Model.loss_fn)`` per micro-batch, their mean, ``adamw.apply`` with the
driver's schedule and the ``TokenPipeline``.  Both start from the
reference's weights: a step-0 checkpoint in the padded layout, written by
the reference, which the port's driver resumes from.  Losses are printed
to 4 decimals; the tolerance is tests/test_torch_grad_compress.py's
``test_torchrun_data_parallel_matches_one_device``'s (2e-4, plus 5e-5 for
the rounding of the print).
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_data
from repro.models import lm as jax_lm
from repro.optim import optimizer as jax_opt
from repro_torch.launch import train

from torch_harness import TOLS

# ``repro.core`` exports the ``pipeline`` scope under the module's name
ref_pipe = importlib.import_module("repro.core.pipeline")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
SL = (2, 1)                        # uneven: 3 layers over 2 stages
BATCH, SEQ, M, STEPS = 4, 32, 2, 3
ARGV = ["--smoke", "--device", "cpu", "--overrides", "n_layers=3", "--pp",
        "2", "--schedule", "1f1b", "--stage-layers", "2,1",
        "--micro-batches", str(M), "--batch", str(BATCH), "--seq", str(SEQ),
        "--log-every", "1"]


def _reference(tmp_path):
    """Seed step-0 checkpoints in ``a`` and ``b`` (the reference's weights
    and AdamW state in the padded layout) and return (the reference's
    losses, its padded initial state)."""
    cfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), n_layers=3)
    jm = jax_lm.build(cfg)
    params = jm.init(jax.random.key(0))
    sched = jax_opt.Schedule(base_lr=3e-4, warmup=min(100, STEPS // 10 + 1),
                             decay_steps=STEPS)
    opt = jax_opt.adamw(lr=sched)
    data = jax_data.TokenPipeline(
        jax_data.DataCfg(global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab,
                         seed=0), host_id=0, n_hosts=1)
    padded = ref_pipe.pipeline_params(jm, params, SL)
    state0 = {"params": padded, "opt": opt.init(padded)}
    for d in ("a", "b"):
        JaxCheckpointManager(str(tmp_path / d)).save(
            0, state0, extra={"data": data.state_dict()})
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    state = opt.init(params)
    losses = []
    for i in range(STEPS):
        toks = jnp.asarray(data.next_batch()["tokens"])
        outs = [grad_fn(params, {"tokens": t}) for t in jnp.split(toks, M)]
        g = jax.tree.map(lambda *x: sum(x) / M, *(g for _, g in outs))
        params, state = opt.apply(g, state, params, i)
        losses.append(float(sum(loss for (loss, _), _ in outs) / M))
    return losses, state0


def _torchrun(argv, tmp_path) -> tuple:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", "-m", "repro_torch.launch.train"] + argv,
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert p.returncode == 0, f"STDOUT:\n{p.stdout}\nSTDERR:\n{p.stderr}"
    losses = [float(line.split()[3]) for line in p.stdout.splitlines()
              if line.strip().startswith("step ")]
    return p.stdout, losses


def _saved(directory, step: int) -> dict:
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        paths = json.load(f)["paths"]
    return {p: np.load(os.path.join(d, f"arr_{i:05d}.npy"))
            for i, p in enumerate(paths)}


def test_torchrun_pipeline_matches_reference_and_resumes(tmp_path):
    want, state0 = _reference(tmp_path)
    out, straight = _torchrun(
        ARGV + ["--steps", str(STEPS), "--ckpt-dir", str(tmp_path / "a")],
        tmp_path)
    assert "[resume] from step 0" in out and out.count("[done] step 3") == 1
    assert "[pipeline] 2 stages, schedule 1f1b, µb=2, stage_layers (2, 1)" \
        in out
    assert "{'stage': 2, 'data': 2, 'model': 1}" in out
    tol = TOLS["float32"].grad
    np.testing.assert_allclose(straight, want, atol=tol + 5e-5, rtol=tol)
    # 2 steps, then a relaunch on the same directory resumes to 3
    _, first = _torchrun(
        ARGV + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")], tmp_path)
    out, rest = _torchrun(
        ARGV + ["--steps", str(STEPS), "--ckpt-dir", str(tmp_path / "b")],
        tmp_path)
    assert "[resume] from step 2" in out and len(rest) == 1
    assert first + rest == straight
    a, b = _saved(tmp_path / "a", STEPS), _saved(tmp_path / "b", STEPS)
    assert sorted(a) == sorted(b)
    for path in a:
        np.testing.assert_allclose(b[path], a[path], rtol=1e-6, atol=0,
                                   err_msg=path)
    # the reference restores it into pipeline_params' layout: its pad rows
    # (stage 1's second row) stayed zero in the parameters and moments
    step, tree, extra = JaxCheckpointManager(str(tmp_path / "a")) \
        .restore_latest(state0)
    assert step == STEPS and extra["data"]["step"] == STEPS
    lmax = max(SL)
    pads = 0
    for path, leaf in zip(a, jax.tree.leaves(tree)):
        leaf = np.asarray(leaf)
        np.testing.assert_array_equal(leaf, a[path])
        if "blocks" in path.split("/"):
            assert leaf.shape[0] == len(SL) * lmax
            assert not leaf[lmax + SL[1]:].any(), path
            pads += 1
    assert pads == 3 * 9       # params, mu, nu: 9 block leaves each


def test_pipeline_flags_refused_without_a_world_they_fit(tmp_path):
    base = ["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    # --pp beside --mesh lays out stage x data x model: 4 ranks here
    with pytest.raises(SystemExit, match="needs 4 ranks"):
        train.main(base + ["--pp", "2", "--mesh", "2"])
    with pytest.raises(SystemExit, match="pod axis beside a pipeline"):
        train.main(base + ["--pp", "2", "--mesh", "1x1x1"])
    with pytest.raises(SystemExit, match="needs a device count divisible "
                                         "by the stage count; have 1"):
        train.main(base + ["--pp", "2", "--schedule", "1f1b",
                           "--stage-layers", "1,1"])
    with pytest.raises(SystemExit):                   # not a schedule
        train.parse_args(base + ["--pp", "2", "--schedule", "zb"])
