"""Slot-granular paged KV cache: the host-side allocator and control state
(the port of ``repro.serve.paged_cache``).

The device half of the paged cache is two page pools per layer
(``models/transformer.init_paged_lm_caches``): K and V tensors of shape
``(n_pages, page_size, KV, dh)``.  A request's cache is a *set* of pages
named by its row of the page table, not a contiguous span, so slots
admit, grow, shrink (sliding-window release) and evict with no cache copy
and no fragmentation.

This module is the HOST half: a free-list :class:`PageAllocator` plus the
small control arrays (page table, per-slot start, liveness, last token)
that the scheduler uploads for every step.  Control state is
host-authoritative: the device never changes it, which is what lets
admission and eviction happen between steps without touching the pools.

Page 0 is the reserved **trash page**: never allocated, the sink of every
masked write (dead slots, positions past the table) and the source that
unallocated page-table entries gather from, whose keys are masked by
position, so trash reads never reach a softmax unmasked
(``models/attention._paged_cache_update``).
"""
from __future__ import annotations

import numpy as np

TRASH_PAGE = 0


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold token positions ``0 .. n_tokens-1``."""
    return -(-n_tokens // page_size) if n_tokens > 0 else 0


class PageAllocator:
    """LIFO free-list over a fixed pool; page 0 (trash) is never handed out.

    Deterministic: the allocation order is a pure function of the
    alloc/release history, so a replayed request stream maps requests to
    the same pages (numerics never depend on WHICH page a slot holds).
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (1 trash + 1 usable), got {n_pages}")
        self.n_pages = n_pages
        # pop() yields low page numbers first.
        self._free = list(range(n_pages - 1, TRASH_PAGE, -1))
        self._free_set = set(self._free)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        """Usable pages (excludes the trash page)."""
        return self.n_pages - 1

    def alloc(self, n: int = 1) -> list[int] | None:
        """``n`` pages, or None if the free list can't cover the request
        (all-or-nothing: a partial grant would deadlock the caller)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        return pages

    def release(self, pages) -> None:
        for p in pages:
            if not (TRASH_PAGE < p < self.n_pages):
                raise ValueError(f"page {p} out of range (1..{self.n_pages - 1})")
            if p in self._free_set:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)
            self._free_set.add(p)


class LaneControl:
    """Per-lane host mirror of the control arrays a decode step consumes.

    ``ptab`` rows use :data:`TRASH_PAGE` (0) for unallocated entries --
    unambiguous because page 0 is never allocated.
    """

    def __init__(self, capacity: int, n_ptab: int):
        self.capacity, self.n_ptab = capacity, n_ptab
        self.ptab = np.zeros((capacity, n_ptab), np.int32)
        self.live = np.zeros((capacity,), bool)
        self.start = np.zeros((capacity,), np.int32)
        self.last_tok = np.zeros((capacity,), np.int32)

    def clear_slot(self, slot: int) -> None:
        self.ptab[slot] = TRASH_PAGE
        self.live[slot] = False
        self.start[slot] = 0
        self.last_tok[slot] = 0

    def free_slots(self) -> list[int]:
        return [i for i in range(self.capacity) if not self.live[i]]
