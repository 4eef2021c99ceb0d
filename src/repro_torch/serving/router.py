"""Prefill/decode disaggregation router over a mixed ClusterSpec: the
port of ``repro/serving/router.py``, pure Python over the ported cost
model and ``hetero``, equal to the reference's with ``==``.

Whale balances *training* work across GPU generations; serving has a
sharper version of the same problem because its two phases stress
different silicon (the HexiScale observation, PAPERS.md):

- **prefill** is one dense forward over the whole prompt — FLOPs-bound,
  priced by :func:`repro_torch.core.cost_model.prefill_time`;
- **decode** re-reads the weights + live KV cache every token — HBM-
  bandwidth-bound, priced by
  :func:`~repro_torch.core.cost_model.decode_step_time`.

A colocated deployment runs both phases on every group, so prefill
bursts stall decode batches and the bandwidth-poor groups drag the token
rate.  The router instead partitions the cluster's device groups into a
prefill pool and a decode pool (group-granular —
:func:`repro_torch.core.hetero.partition_cluster`), prices every one of
the ``2^G − 2`` partitions with the serving cost model, and picks the one
with the highest *serviceable request rate* — the min of what the
prefill pool can admit and what the decode pool can emit, KV handoff
riding the bottleneck cross-pool link in between.

Nothing about "V100s do decode" is hard-coded: the assignment falls out
of the Hardware tables (V100: 900 GB/s HBM → bandwidth-rich, decode;
T4: 65 TFLOP/s against 300 GB/s → relatively compute-rich, prefill).
"""
from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core.cost_model import (ClusterSpec, ServingMeta,
                                         decode_step_time, kv_handoff_time,
                                         prefill_time, serving_page_budget)
from repro_torch.core.hetero import partition_cluster


@dataclasses.dataclass(frozen=True)
class DisaggPlan:
    """One priced prefill/decode partition of a cluster."""
    prefill: ClusterSpec
    decode: ClusterSpec
    prefill_req_rate: float      # prompts/s the prefill pool sustains
    decode_tok_rate: float       # tokens/s the decode pool sustains
    handoff_s: float             # per-request KV handoff latency
    page_budget: int             # decode-pool KV pages (admission control)
    concurrency: int             # steady-state decode sequences

    @property
    def request_rate(self) -> float:
        """Serviceable requests/s at the scenario's mean gen length —
        the bottleneck of admission (prefill) and emission (decode)."""
        return min(self.prefill_req_rate, self._decode_req_rate)

    # set by route(); stored so request_rate stays self-contained
    _decode_req_rate: float = 0.0

    def describe(self) -> str:
        pf = "+".join(f"{g.n_devices}×{g.hw.name}" for g in self.prefill.groups)
        dc = "+".join(f"{g.n_devices}×{g.hw.name}" for g in self.decode.groups)
        return (f"prefill[{pf}] → decode[{dc}]  "
                f"{self.prefill_req_rate:.1f} req/s in, "
                f"{self.decode_tok_rate:.0f} tok/s out, "
                f"handoff {self.handoff_s * 1e3:.1f} ms, "
                f"{self.page_budget} pages")


def _cross_pool_bw(prefill: ClusterSpec, decode: ClusterSpec) -> float:
    """KV handoff rides the slow (inter-server) link; bottleneck of the
    two pools' slow-link bandwidths."""
    return min(min(g.hw.link_bw["slow"] for g in prefill.groups),
               min(g.hw.link_bw["slow"] for g in decode.groups))


def price_partition(meta: ServingMeta, prefill: ClusterSpec,
                    decode: ClusterSpec, *, mean_prompt: int, mean_gen: int,
                    page_size: int, batch_slots: int,
                    reserve: float = 0.2) -> DisaggPlan:
    """Price one (prefill pool, decode pool) split of the cluster."""
    pf_rate = sum(1.0 / prefill_time(meta, g, mean_prompt)
                  for g in prefill.groups)
    # steady-state decode: each decode group runs batch_slots slots capped
    # by its page budget at the mean live context (prompt + half the gen)
    mean_ctx = mean_prompt + mean_gen / 2.0
    pages_per_seq = -(-int(mean_ctx) // page_size)
    tok_rate = 0.0
    budget = 0
    conc_total = 0
    for g in decode.groups:
        pages = serving_page_budget(meta, g, page_size, reserve=reserve)
        budget += pages
        conc = min(batch_slots, max(pages // max(pages_per_seq, 1), 0))
        if conc <= 0:
            continue
        step = decode_step_time(meta, g, conc, conc * mean_ctx)
        tok_rate += conc / step
        conc_total += conc
    handoff = kv_handoff_time(meta, mean_prompt,
                              _cross_pool_bw(prefill, decode))
    return DisaggPlan(
        prefill=prefill, decode=decode, prefill_req_rate=pf_rate,
        decode_tok_rate=tok_rate, handoff_s=handoff, page_budget=budget,
        concurrency=conc_total,
        _decode_req_rate=tok_rate / max(mean_gen, 1))


def route(meta: ServingMeta, spec: ClusterSpec, *, mean_prompt: int,
          mean_gen: int, page_size: int, batch_slots: int,
          reserve: float = 0.2) -> DisaggPlan:
    """Best prefill/decode partition of ``spec`` for the workload shape.

    Exhaustive over the ``2^G − 2`` group partitions (G is small — a
    cluster has a handful of hardware kinds, not a handful of devices).
    Raises on a single-group spec: there is nothing to disaggregate —
    the caller should run colocated instead.
    """
    names = [g.name for g in spec.groups]
    if len(names) < 2:
        raise ValueError(
            f"disaggregation needs >= 2 device groups, got {names}; run "
            f"the colocated server on a single-group cluster")
    best = None
    for r in range(1, len(names)):
        for picked in itertools.combinations(names, r):
            prefill, decode = partition_cluster(spec, picked)
            plan = price_partition(
                meta, prefill, decode, mean_prompt=mean_prompt,
                mean_gen=mean_gen, page_size=page_size,
                batch_slots=batch_slots, reserve=reserve)
            if plan.page_budget <= 0 or plan.concurrency <= 0:
                continue                 # decode pool cannot hold any KV
            if best is None or plan.request_rate > best.request_rate:
                best = plan
    if best is None:
        raise ValueError(
            f"no partition of {names} yields a feasible decode pool "
            f"(weights alone exhaust every candidate pool's HBM)")
    return best
