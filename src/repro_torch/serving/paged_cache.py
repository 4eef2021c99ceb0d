"""Paged (block) KV cache: fixed-size pages + slot→page block tables.

A copy of ``repro.serving.paged_cache`` (numpy only), so the port needs
nothing of the reference package.

The dense serving cache reserves ``max_len`` KV rows per decode slot the
moment a request is admitted — a 16-token prompt generating 16 tokens
holds (and every decode step *reads*) a 2048-row reservation.  The paged
cache (the vLLM idea) splits the cache into fixed-size **pages** shared by
all slots:

- the device holds per-layer page **pools** ``(n_rep, n_pages, page_size,
  K, D)`` plus a ``(slots, max_pages)`` int32 **block table** mapping each
  slot's logical page index to a physical page;
- pages are allocated on demand — at admission enough pages to cover the
  prompt, then one more every ``page_size`` decode steps — from a
  host-side free list (:class:`PageAllocator`);
- physical page 0 is the **trash page**: never allocated, every
  unallocated block-table entry points at it, and *inactive* slots write
  their garbage KV into it — so the decode scatter runs for all slots
  unconditionally, with no host-side active mask.

Allocation state machine (admission control — DESIGN.md §9):

    ADMIT    pages_for(prompt) available?  → alloc (all-or-nothing)
             else                          → request stays queued
    DECODE   pos crossed a page boundary?  → alloc 1 page (zeroed)
             pool exhausted?               → PREEMPT a victim slot
                                             (pages freed, request re-queued)
    FINISH   → free the slot's pages (contents left stale — the next
               owner zeroes pages at allocation, which is what makes
               slot-recycle safe under the one-hot ADD decode write)

Everything here is host-side bookkeeping over numpy arrays; the device
tensors (pools / block table / pos) are owned by the caller
(``serving/server.py``) — this module never imports torch.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Static geometry of one paged cache."""
    n_pages: int                 # physical pages in the pool (incl. trash)
    page_size: int               # KV rows per page
    max_pages: int               # logical pages per slot (block-table width)

    def __post_init__(self):
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive, got "
                             f"{self.page_size}")
        if self.n_pages < 2:
            raise ValueError(
                f"need >= 2 physical pages (page 0 is the trash page), "
                f"got {self.n_pages}")
        if self.max_pages <= 0:
            raise ValueError(f"max_pages must be positive, got "
                             f"{self.max_pages}")

    @property
    def max_len(self) -> int:
        """Longest sequence one slot can hold."""
        return self.max_pages * self.page_size

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1          # page 0 is reserved

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV rows."""
        return -(-n_tokens // self.page_size)


class PageAllocator:
    """Free-list allocator over the physical pages of one pool.

    All-or-nothing allocation (a request either gets every page it asked
    for or none), per-slot ownership tracking, and loud errors on every
    misuse — double-free and foreign-free bugs corrupt *other requests'*
    caches, which is the worst silent failure a serving tier can have.
    """

    def __init__(self, cfg: PagedCacheConfig):
        self.cfg = cfg
        self._free = list(range(cfg.n_pages - 1, 0, -1))  # pop() → page 1 first
        self._owned: dict = {}           # slot → [physical pages]

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.cfg.usable_pages - len(self._free)

    def owned(self, slot: int) -> list:
        return list(self._owned.get(slot, []))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, slot: int, n: int) -> list:
        """Give ``slot`` ``n`` more pages (all-or-nothing)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise MemoryError(
                f"pool exhausted: slot {slot} asked for {n} pages, "
                f"{len(self._free)}/{self.cfg.usable_pages} free")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(slot, []).extend(pages)
        return pages

    def free_slot(self, slot: int) -> list:
        """Release every page ``slot`` owns; returns them (stale contents)."""
        pages = self._owned.pop(slot, [])
        for p in pages:
            if p in self._free:
                raise RuntimeError(
                    f"double free of page {p} (slot {slot}) — the free "
                    f"list is corrupt")
        self._free.extend(reversed(pages))
        return pages

    def reset(self):
        self._free = list(range(self.cfg.n_pages - 1, 0, -1))
        self._owned = {}


class BlockTable:
    """Host-side mirror of the device block table + per-slot positions.

    The device copy is just ``torch.as_tensor`` of these arrays each step (a
    few KiB); keeping the mutable source of truth on the host avoids a
    device round-trip per admission/page-allocation.
    """

    def __init__(self, slots: int, cfg: PagedCacheConfig):
        self.cfg = cfg
        self.table = np.zeros((slots, cfg.max_pages), np.int32)  # 0 = trash
        self.pos = np.zeros((slots,), np.int32)

    def assign(self, slot: int, pages: list, pos: int):
        """Point ``slot`` at ``pages`` (logical order) starting empty."""
        if len(pages) > self.cfg.max_pages:
            raise ValueError(
                f"{len(pages)} pages exceed the block-table width "
                f"{self.cfg.max_pages}")
        self.table[slot] = 0
        self.table[slot, :len(pages)] = pages
        self.pos[slot] = pos

    def append_page(self, slot: int, page: int):
        idx = int(np.argmax(self.table[slot] == 0))
        if self.table[slot, idx] != 0:
            raise ValueError(f"slot {slot} block table is full")
        self.table[slot, idx] = page

    def clear(self, slot: int):
        self.table[slot] = 0
        self.pos[slot] = 0

    def needs_page(self, slot: int) -> bool:
        """Does the *next* decode write land on an unallocated page?"""
        idx = int(self.pos[slot]) // self.cfg.page_size
        if idx >= self.cfg.max_pages:
            return False                 # out of table — caller enforces max_len
        return self.table[slot, idx] == 0
