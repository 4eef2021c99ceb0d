"""Continuous-batching server core: dense or paged KV cache.

A fixed batch of decode *slots* advanced in lock-step by the model's
``serve_step``, with per-request prefill at admission.  Two cache modes:

- ``cache="dense"`` — every slot owns ``max_len`` KV rows from admission
  to finish (or, for SSD blocks, its O(1) state).
- ``cache="paged"`` — slots hold pages from a shared pool through a block
  table (:mod:`repro_torch.serving.paged_cache`); admission is gated on
  page availability, pages are appended as decode crosses page
  boundaries, and pool exhaustion preempts the youngest slot (its request
  re-queues and restarts).  Decode reads KV through the paged kernel.
  Only all-attention models take it.

Prompts are right-padded to power-of-two buckets (min 8), as in the
reference, so prefill runs at O(log max_len) distinct shapes; ``last_idx``
keeps the padded prefill exact (logits read at the true last token, pad
KV zeroed).

The decode hot path does exactly **one** host sync per step: a single
device→host copy of the argmax'd next tokens for every slot at once.

Over a mesh (``Server(model, plan)``, the plan from
:func:`~repro_torch.core.planner.compile_plan`) every rank runs this same
loop on the same request stream, the SPMD counterpart of the reference's
single-controller Server.  The host bookkeeping (admission, the page
allocator and block table, preemption, completion) is global and reads
only values equal on every rank: each step's tokens are gathered over the
data axes, and an admission's first token is its slot owner's.  The
device state is this rank's block by the plan's state specs:

- slots split over the data axes (``batch_slots % dp`` must be 0); a rank
  holds the dense state, block-table rows and positions of its slots;
- prefill runs on every rank, replicated over data and split over
  ``model``, and only the slot's owner writes the result: into a
  sequence-split dense cache by gathering the prefill's heads over
  ``model`` and keeping this rank's rows, into a head-split one (or the
  pools) as it is;
- the page pools leave pages whole over data, and the allocator is
  identical on every rank, so each data rank writes and reads only the
  pages of its own slots.  Pages of other replicas' slots stay zero or
  stale on this rank and are never read through its block-table rows;
  the trash page stays zero, and a page is zeroed by its owner when
  allocated.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sharding
from repro_torch.core.planner import compile_plan
from repro_torch.kernels.autotune import DEFAULT_TILES
from repro_torch.serving.paged_cache import (BlockTable, PageAllocator,
                                             PagedCacheConfig)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    preemptions: int = 0


def prompt_bucket(n: int, max_len: int, lo: int = 8) -> int:
    """Smallest power-of-two ≥ ``n`` (min ``lo``), capped at ``max_len`` —
    the padded prefill length."""
    if n > max_len:
        raise ValueError(f"prompt length {n} exceeds max_len {max_len}")
    b = lo
    while b < n:
        b <<= 1
    return min(b, max_len)


class Server:
    """``plan``: an :class:`~repro_torch.core.planner.ExecutionPlan` over a
    mesh (the module doc), or ``None`` for one device."""

    def __init__(self, model, plan=None, *, batch_slots: int, max_len: int,
                 eos_id: int = 1, cache: str = "dense", page_size: int = 0,
                 n_pages: int = 0):
        if cache not in ("dense", "paged"):
            raise ValueError(f"cache must be dense|paged, got {cache!r}")
        self.model = model
        self.plan = plan if plan is not None else compile_plan(model, None)
        self.lo, self.hi = self.plan.slot_block(batch_slots)  # this rank's
        self.device = model.device
        self.B = batch_slots
        self.max_len = max_len
        self.eos = eos_id
        self.cache = cache
        self._buckets: set = set()        # prompt buckets prefilled so far
        self.tokens = torch.zeros((batch_slots,), dtype=torch.long,
                                  device=self.device)
        self.slots: list = [None] * batch_slots
        self.requeued: list = []          # preempted requests (paged)
        self.steps = 0
        self._admit_seq = 0
        self._seq_of: dict = {}           # slot → admission sequence no.

        if cache == "paged":
            if not model.supports_paged:
                raise ValueError(
                    f"arch {model.cfg.family!r} does not support the paged "
                    f"KV cache")
            ps = page_size or DEFAULT_TILES.page_size
            if max_len % ps:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of the page "
                    f"size {ps}")
            max_pages = max_len // ps
            # default pool: full residency for every slot (no preemption)
            n_pages = n_pages or 1 + batch_slots * max_pages
            self.pcfg = PagedCacheConfig(n_pages, ps, max_pages)
            self.alloc = PageAllocator(self.pcfg)
            self.table = BlockTable(batch_slots, self.pcfg)
            self._step = self.plan.serve_step_paged_fn(batch_slots, n_pages,
                                                       ps, max_pages)
            self.pools = self.plan.local_zeros(
                model.paged_state_shapes(batch_slots, n_pages, ps,
                                         max_pages)["pools"],
                self.plan.paged_state_specs(batch_slots, n_pages, ps,
                                            max_pages)["pools"])
        else:
            self._step = self.plan.serve_step_fn(batch_slots, max_len)
            self._specs = self.plan.state_specs(batch_slots, max_len)
            self.state = self.plan.local_zeros(
                model.decode_state_shapes(batch_slots, max_len), self._specs)

    @property
    def prefill_cache_size(self) -> int:
        """Distinct prompt buckets prefilled (the reference's jit cache)."""
        return len(self._buckets)

    def _run_prefill(self, params, prompt: np.ndarray):
        S = len(prompt)
        bucket = prompt_bucket(S, self.max_len)
        self._buckets.add(bucket)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :S] = prompt
        gb = 0 if self.cache == "paged" else self.max_len - bucket
        return self.plan.prefill_fn(gb)(
            params, {"tokens": torch.tensor(tokens, device=self.device)},
            last_idx=torch.tensor([S - 1], device=self.device))

    def _owns(self, slot: int) -> bool:
        return self.lo <= slot < self.hi

    # --- admission ---
    def can_admit(self, req: Request) -> bool:
        """Admission control: slot capacity is checked by the caller via
        :meth:`free_slot`; paged mode additionally requires the prompt's
        pages *now* and bounds the sequence by the block-table width."""
        S = len(req.prompt)
        if S + req.max_new > self.max_len:
            return False
        if self.cache == "paged":
            return self.alloc.can_alloc(self.pcfg.pages_for(S))
        return True

    def admit(self, params, req: Request, slot: int) -> None:
        """Prefill ``req`` into ``slot``.  A request that finishes at
        admission (EOS from prefill, or a one-token budget) is marked
        ``done`` and never occupies the slot — the caller collects it."""
        S = len(req.prompt)
        logits, st = self._run_prefill(params, np.asarray(req.prompt))
        first = logits[0, :self.model.cfg.vocab].argmax()
        if self.plan.mesh is not None:       # the slot owner's token
            first = self.plan.gather_slots(first[None])[
                slot // (self.hi - self.lo)]
        tok = int(first)
        req.out_tokens.append(tok)
        if tok == self.eos or len(req.out_tokens) >= req.max_new:
            req.done = True
            return
        if self.cache == "paged":
            pages = self.alloc.alloc(slot, self.pcfg.pages_for(S))
            if self._owns(slot):
                self._write_prompt_pages(st["cache"], pages)
            self.table.assign(slot, pages, pos=S)
        elif self._owns(slot):
            self._write_slot(st, slot - self.lo)
        self.tokens[slot] = tok
        self.slots[slot] = req
        self._seq_of[slot] = self._admit_seq
        self._admit_seq += 1

    def _write_slot(self, st: dict, slot: int) -> None:
        """Copy a batch-1 prefill state into local slot ``slot`` of the
        dense cache: KV padded or cropped in length to ``max_len``, an SSD
        state leaf copied whole.  Where the state spec splits the cache's
        sequence (``kv_seq``) the prefill's heads are gathered over
        ``model`` and this rank's rows kept."""
        rules = self.plan.rules
        for name, leaves in st["cache"].items():
            for key, small in leaves.items():
                big = self.state["cache"][name][key]
                if key in ("k", "v"):                   # (L, B, Smax, K, D)
                    seq = self._specs["cache"][name][key][2]
                    r0 = 0
                    if seq is not None:
                        small = sharding.gather_cat(small, rules.group(seq),
                                                    3)
                        r0 = rules.index(seq) * big.shape[2]
                    rows = small[:, 0, r0:r0 + big.shape[2]]
                    big[:, slot].zero_()
                    big[:, slot, :rows.shape[1]] = rows
                else:                                   # (L, B, ...) state
                    big[:, slot] = small[:, 0]
        self.state["pos"][slot] = st["pos"][0]

    def _write_prompt_pages(self, cache: dict, pages: list) -> None:
        """Copy a batch-1 prefill KV cache into freshly allocated pages.

        Whole pages are overwritten, so this is also what *zeroes* them
        (prefill zeroed rows past ``last_idx``) — stale contents from a
        previous owner can never leak into the new sequence.
        """
        ps = self.pcfg.page_size
        rows = len(pages) * ps
        idx = torch.tensor(pages, device=self.device)
        for name, kv in cache.items():
            for key in ("k", "v"):
                a = kv[key][:, 0]                    # (L, bucket, K, D)
                if a.shape[1] < rows:
                    a = torch.nn.functional.pad(
                        a, (0, 0, 0, 0, 0, rows - a.shape[1]))
                else:
                    a = a[:, :rows]
                a = a.reshape(a.shape[0], len(pages), ps, *a.shape[2:])
                pool = self.pools[name][key]
                pool[:, idx] = a.to(pool.dtype)

    def _zero_pages(self, pages: list) -> None:
        idx = torch.tensor(pages, device=self.device)
        for name in self.pools:
            for key in ("k", "v"):
                self.pools[name][key][:, idx] = 0

    # --- paged bookkeeping ---
    def _preempt_victim(self, needy_slot: int) -> None:
        """Free the youngest-admitted active slot's pages; its request
        restarts from scratch via :attr:`requeued`."""
        candidates = [b for b, r in enumerate(self.slots)
                      if r is not None and b != needy_slot]
        victim = (max(candidates, key=lambda b: self._seq_of[b])
                  if candidates else needy_slot)
        req = self.slots[victim]
        req.out_tokens = []
        req.done = False
        req.preemptions += 1
        self.alloc.free_slot(victim)
        self.table.clear(victim)
        self.slots[victim] = None
        self._seq_of.pop(victim, None)
        self.requeued.append(req)

    def _grow_tables(self) -> None:
        """Append a page to every active slot whose next write would land
        on an unallocated (trash) page, preempting on exhaustion."""
        for b, req in enumerate(self.slots):
            if req is None or not self.table.needs_page(b):
                continue
            while not self.alloc.can_alloc(1):
                self._preempt_victim(b)
                if self.slots[b] is None:      # preempted ourselves
                    break
            if self.slots[b] is None:
                continue
            page = self.alloc.alloc(b, 1)[0]
            if self._owns(b):
                self._zero_pages([page])
            self.table.append_page(b, page)

    # --- decode ---
    def step(self, params) -> list:
        """Advance every active slot one token; returns the requests that
        finished this step (their slots are recycled in the same pass)."""
        lo, hi = self.lo, self.hi
        if self.cache == "paged":
            self._grow_tables()
            state = {"pools": self.pools,
                     "block_table": torch.tensor(self.table.table[lo:hi],
                                                 device=self.device),
                     "pos": torch.tensor(self.table.pos[lo:hi],
                                         device=self.device)}
            logits, _ = self._step(params, self.tokens[lo:hi], state)
        else:
            logits, self.state = self._step(params, self.tokens[lo:hi],
                                            self.state)
        nxt = logits[:, :self.model.cfg.vocab].argmax(dim=-1)
        if self.plan.mesh is not None:       # every rank's slots
            nxt = self.plan.gather_slots(nxt)
        self.tokens = nxt.to(self.device)
        nxt = nxt.cpu().numpy()              # ONE host sync for the batch
        self.steps += 1
        finished = []
        for b, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            if self.cache == "paged":
                self.table.pos[b] += 1
            tok = int(nxt[b])
            req.out_tokens.append(tok)
            if tok == self.eos or len(req.out_tokens) >= req.max_new:
                req.done = True
                self.slots[b] = None          # recycle the slot …
                self._seq_of.pop(b, None)
                if self.cache == "paged":
                    self.alloc.free_slot(b)
                    self.table.clear(b)
                finished.append(req)          # … but hand the request back
        return finished

    def free_slot(self) -> int | None:
        for b, s in enumerate(self.slots):
            if s is None:
                return b
        return None

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def take_requeued(self) -> list:
        out, self.requeued = self.requeued, []
        return out
