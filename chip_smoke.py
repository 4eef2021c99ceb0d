#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing its lines; any failed check raises and the script
exits non-zero without printing a result:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes tinyllama-1.1b gives it (tolerance f32 2e-5, bf16 2e-2), and time
   the kernel, the plain version and one PyTorch library call computing
   the same function (a yardstick the port never calls);
4. the main path: ``repro_torch.launch.serve`` serving tinyllama-1.1b at
   full width with the paged KV cache — 16 requests of 500 prompt tokens
   and 64 generated through 8 slots — with every kernel's launch count
   read around it;
5. the same driver with the dense KV cache, 4 requests;
6. a small model on the card against the same model on the CPU (the plain
   versions), logits within 1e-4;
7. where the time goes in the main path's configuration: a prefill and
   a decode step on the host clock, then the device's busy share and top
   kernels under ``torch.profiler``;

then the kernel table as one JSON line, the card line again, and the last
line ``{"ok": true, "device": {...}}``.  Needs no network; needs ``nvcc``
(``CUDA_HOME`` or ``/usr/local/cuda``).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12             # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.bfloat16": 2e-2, "torch.float32": 2e-5}
ARCH = "tinyllama-1.1b"
PAGED_ARGS = ["--arch", ARCH, "--cache", "paged", "--requests", "16",
              "--batch-slots", "8", "--prompt-len", "500", "--gen", "64",
              "--max-len", "1024", "--page-size", "64"]
DENSE_ARGS = ["--arch", ARCH, "--cache", "dense", "--requests", "4",
              "--batch-slots", "4", "--prompt-len", "500", "--gen", "32",
              "--max-len", "1024"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of one call, L2 flushed before each launch (the
    serving path finds its per-layer KV and weights cold)."""

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got, want, dtype) -> float:
    """|got - want| <= tol + tol·|want| everywhere (the reference's
    allclose policy, tests/kernel_harness.py); returns max |got - want|."""
    tol = TOL[str(dtype)]
    diff = (got.float() - want.float()).abs()
    bad = ~(diff <= tol + tol * want.float().abs())      # NaN counts as bad
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"{tol:g}; max |err| {float(diff.max()):.3e}")
    return float(diff.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(torch, timer) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, K, D = 32, 4, 64
    cases = [(256, 256, True), (512, 512, True), (1024, 1024, True),
             (384, 1000, False)]
    row = None
    for Sq, Sk, causal in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((1, Sq, H, D), generator=gen, device="cuda"
                            ).to(dtype)
            k = torch.randn((1, Sk, K, D), generator=gen, device="cuda"
                            ).to(dtype)
            v = torch.randn((1, Sk, K, D), generator=gen, device="cuda"
                            ).to(dtype)
            o, lse = flash.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal)
            tag = f"flash_fwd Sq={Sq} Sk={Sk} causal={causal} {dtype}"
            err = max(check_close(tag + " o", o, o_ref, dtype),
                      check_close(tag + " lse", lse, lse_ref, dtype))
            ms = timer(lambda: flash.flash_attention(q, k, v, causal))
            plain_ms = timer(lambda: flash.flash_attention_plain(q, k, v,
                                                                 causal))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
            pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
            flops = 4 * pairs * H * D
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size() + lse.numel() * 4
            b_ms, b_by = bound(nbytes, flops, dtype)
            print(f"[kernel] {tag}: max_abs_err {err:.3e} (tol "
                  f"{TOL[str(dtype)]:g})  kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa "
                  f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
            if (Sq, causal, dtype) == (512, True, torch.bfloat16):
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return row


def check_paged(torch, timer) -> dict:
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import paged

    rng = np.random.default_rng(0)
    B, H, K, D, ps, mp = 8, 32, 4, 64, 64, 16
    P = 1 + B * mp
    pos = rng.integers(500, mp * ps, B)
    pos[3] = 0                                     # the inactive slot
    table = np.zeros((B, mp), np.int32)
    perm = rng.permutation(np.arange(1, P)).tolist()
    for b in range(B):
        if b != 3:
            n = int(pos[b]) // ps + 1
            table[b, :n] = [perm.pop() for _ in range(n)]
    bt = torch.tensor(table, device="cuda")
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    row = None
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
        kp = torch.randn((P, ps, K, D), generator=gen, device="cuda"
                         ).to(dtype)
        vp = torch.randn((P, ps, K, D), generator=gen, device="cuda"
                         ).to(dtype)
        kp[0] = 0
        vp[0] = 0
        out = paged.paged_decode(q, kp, vp, bt, pos_t)
        torch.cuda.synchronize()
        ref = paged.paged_decode_plain(q, kp, vp, bt, pos_t)
        tag = f"paged_decode B={B} pos={pos.tolist()} {dtype}"
        err = check_close(tag, out, ref, dtype)
        if not torch.isfinite(out[3]).all():
            raise AssertionError("paged_decode: inactive slot not finite")
        ms = timer(lambda: paged.paged_decode(q, kp, vp, bt, pos_t))
        plain_ms = timer(lambda: paged.paged_decode_plain(q, kp, vp, bt,
                                                          pos_t))
        # yardstick: SDPA over the same KV gathered dense beforehand
        kd = kp[bt.long()].reshape(B, mp * ps, K, D).transpose(1, 2
                                                               ).contiguous()
        vd = vp[bt.long()].reshape(B, mp * ps, K, D).transpose(1, 2
                                                               ).contiguous()
        mask = (torch.arange(mp * ps, device="cuda")[None, :]
                <= pos_t[:, None].long())[:, None, None, :]
        qd = q[:, :, None, :]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True))
        live = int((pos + 1).sum())
        nbytes = (2 * q.numel() + 2 * live * K * D) * q.element_size() \
            + bt.numel() * 4 + B * 4
        flops = 4 * live * H * D
        b_ms, b_by = bound(nbytes, flops, dtype)
        print(f"[kernel] {tag}: max_abs_err {err:.3e} (tol "
              f"{TOL[str(dtype)]:g})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  sdpa(pre-gathered) {lib_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        if dtype == torch.bfloat16:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return row


# ---------------------------------------------------------------------------
# phases 4-6: the serving driver at full width, and a small-model agreement
# ---------------------------------------------------------------------------

def reset_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0


def serve_paged(torch, kernels) -> dict:
    from repro_torch.launch import serve

    flash, paged = kernels
    reset_counts(kernels)
    summary, server = serve.run(serve.parse_args(PAGED_ARGS))
    counts = {"flash_fwd": flash.launches, "paged_decode": paged.launches}
    layers = server.model.cfg.n_layers
    print(f"[main] paged serve: {summary['completed']} requests, "
          f"{summary['tokens']} tokens, {summary['steps']} decode steps in "
          f"{summary['seconds']:.3f} s = "
          f"{summary['tokens'] / summary['seconds']:.1f} tok/s; launches "
          f"{counts}", flush=True)
    if summary["completed"] != 16:
        raise AssertionError(f"paged serve completed {summary['completed']}")
    if counts["flash_fwd"] != layers * 16:
        raise AssertionError(f"flash launches {counts['flash_fwd']} != "
                             f"{layers} per admission x 16")
    if counts["paged_decode"] != layers * summary["steps"] or not counts[
            "paged_decode"]:
        raise AssertionError(f"paged launches {counts['paged_decode']} != "
                             f"{layers} per step x {summary['steps']}")
    for name, kv in server.pools.items():
        for key, pool in kv.items():
            if pool[:, 0].any():
                raise AssertionError(f"trash page of {name}/{key} written")
            if not torch.isfinite(pool).all():
                raise AssertionError(f"non-finite KV in {name}/{key}")
    print("[main] trash page all zero, KV pools finite", flush=True)
    return counts


def serve_dense(kernels) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    flash, paged = kernels
    reset_counts(kernels)
    summary = serve.main(DENSE_ARGS)
    print(f"[dense] {summary['completed']} requests, {summary['tokens']} "
          f"tokens, {summary['steps']} steps in {summary['seconds']:.3f} s "
          f"= {summary['tokens'] / summary['seconds']:.1f} tok/s; launches "
          f"flash_fwd {flash.launches}, paged_decode {paged.launches}",
          flush=True)
    layers = get_config(ARCH).n_layers
    if summary["completed"] != 4 or flash.launches != layers * 4 \
            or paged.launches:
        raise AssertionError("dense serve did not run as expected")


def small_model_agreement(torch) -> None:
    """A 2-layer f32 model (GQA 8:2, head_dim 64) on the card against the
    same weights on the CPU, where the wrappers run the plain versions:
    prefill, then paged decode steps."""
    from repro_torch.configs import get_config, shrink
    from repro_torch.models.lm import Model

    cfg = shrink(get_config(ARCH), n_heads=8, n_kv_heads=2, head_dim=64)
    cpu, gpu = Model(cfg, "cpu"), Model(cfg, "cuda")
    params = cpu.init(0)
    gparams = _to(params, "cuda")
    tokens = torch.randint(0, cfg.vocab, (1, 40),
                           generator=torch.Generator().manual_seed(0))
    last = torch.tensor([36])
    outs = {}
    for name, model, p in (("cpu", cpu, params), ("cuda", gpu, gparams)):
        dev = model.device
        logits, st = model.prefill(p, {"tokens": tokens.to(dev)},
                                   gen_budget=0, last_idx=last.to(dev))
        ps = 8
        pools = model.paged_pools(8, ps)
        for key in ("k", "v"):
            a = st["cache"]["p0"][key][:, 0, :40]
            pools["p0"][key][:, 1:6] = a.reshape(a.shape[0], 5, ps,
                                                 *a.shape[2:])
        table = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 0]], dtype=torch.int32,
                             device=dev)
        state = {"pools": pools, "block_table": table,
                 "pos": torch.tensor([37], dtype=torch.int32, device=dev)}
        seq = [logits]
        tok = logits[:, :cfg.vocab].argmax(-1)
        for _ in range(8):
            logits, state = model.serve_step_paged(p, tok, state)
            seq.append(logits)
            tok = logits[:, :cfg.vocab].argmax(-1)
        outs[name] = torch.stack(seq).cpu()
    worst = max_err(outs["cuda"], outs["cpu"])
    if not worst <= 1e-4:
        raise AssertionError(f"card vs cpu logits differ by {worst:.3e}")
    print(f"[agree] 2-layer f32 model, prefill + 8 paged steps: card vs cpu "
          f"max |logit err| {worst:.3e} (limit 1e-4)", flush=True)


def where_the_time_goes(torch) -> None:
    """The main path's configuration, split by phase: one 500-token
    prefill, then decode steps of 8 live slots (~500-token contexts) —
    timed with the host clock around a sync, then once more under
    torch.profiler for the device's busy share and its top kernels."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.serving.server import Request, Server

    cfg = get_config(ARCH)
    model = Model(cfg)
    params = model.serving_params(model.init(0))
    server = Server(model, batch_slots=8, max_len=1024, cache="paged",
                    page_size=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 500, dtype=np.int32)
               for _ in range(9)]
    server.admit(params, Request(99, prompts[8], max_new=2), 0)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(8):
        server.admit(params, Request(b, prompts[b], max_new=500), b)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) / 8 * 1e3
    for _ in range(3):
        server.step(params)
    n = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        server.step(params)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            server.step(params)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / n * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                       # union of kernel intervals (µs)
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / n / 1e3
    print(f"[time] prefill of one 500-token prompt (bucket 512): "
          f"{prefill_ms:.2f} ms; decode step, 8 slots: {step_ms:.2f} ms "
          f"({8 / step_ms * 1e3:.1f} tok/s)", flush=True)
    if not spans:
        print("[time] profiler saw no device activity: busy share not "
              "measured", flush=True)
        return
    print(f"[time] under the profiler: step {prof_ms:.2f} ms, device busy "
          f"{busy_ms:.3f} ms per step, idle share "
          f"{1 - busy_ms / prof_ms:.3f}", flush=True)
    avgs = sorted(prof.key_averages(),
                  key=lambda e: -getattr(e, "self_device_time_total", 0))
    for e in avgs[:8]:
        t = getattr(e, "self_device_time_total", 0) / n / 1e3
        print(f"[time]   {t:.4f} ms/step  x{e.count // n:<4d} {e.key[:90]}",
              flush=True)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash, paged

    card = card_line()
    print("[card] nvidia-smi name, power.limit:", flush=True)
    print(card, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    so = build.build()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("[build]", line.strip(), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(torch)
    rows = {"flash_fwd": check_flash(torch, timer),
            "paged_decode": check_paged(torch, timer)}
    del timer

    kernels = (flash.flash_attention, paged.paged_decode)
    counts = serve_paged(torch, kernels)
    serve_dense(kernels)
    small_model_agreement(torch)
    where_the_time_goes(torch)

    meta = {
        "flash_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                      "src/repro/kernels/flash_attention/flash.py:52"),
        "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                         "src/repro/kernels/flash_attention/paged.py:45"),
    }
    table = [dict(name=name, route="cuda", source=meta[name][0],
                  replaces=meta[name][1], launches=counts[name], **rows[name])
             for name in rows]
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
