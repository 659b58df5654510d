"""Paged KV cache: a page pool plus a free-list allocator, so the serve slot
count and sequence length stop sizing the cache up front.

The cache is cut into fixed ``page_size``-row pages in one physical pool:

  * each request owns just enough pages for its current depth, taken from
    a host-side free list as decode crosses page boundaries;
  * the decode step receives a ``(slots, max_pages)`` page table; attention
    gathers each slot's logical view out of the pool and scatters the new
    token's K/V at its physical row (``models.attention``, paged branch);
  * physical page 0 is reserved as the null target: unallocated table
    entries point at it, inactive slots write their unused row into it, and
    the per-row position masks keep it out of every softmax.

The allocator reports exhaustion precisely (``PagesExhausted`` carries the
shortfall, nothing is half-allocated) and tracks ownership per request, so
preemption frees exactly one victim's pages.  The free list is LIFO and
deterministic: a replayed run allocates the identical physical pages.

The pools are updated in place (the reference's functional updates donate
the old buffer to the same effect).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig


class PagesExhausted(RuntimeError):
    """Raised by ``PageAllocator.alloc`` when the pool cannot satisfy the
    request; carries the shortfall.  The failed alloc has no side effects."""

    def __init__(self, needed: int, available: int):
        super().__init__(
            f"KV page pool exhausted: need {needed} pages, {available} free")
        self.needed = needed
        self.available = available


class PageAllocator:
    """Deterministic free-list allocator over physical page ids
    ``[first, first + total)``.  A page is either free or owned by exactly
    one live owner; ``free_owner`` returns every page an owner held."""

    def __init__(self, total: int, *, first: int = 1):
        if total < 1:
            raise ValueError(f"page pool needs >= 1 page, got {total}")
        self.total = total
        self.first = first
        # LIFO: lowest ids come back out first (reversed push order).
        self._free: list[int] = list(range(first + total - 1, first - 1, -1))
        self._owned: dict[object, list[int]] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def live_owners(self) -> int:
        return len(self._owned)

    def owned(self, owner) -> list[int]:
        return list(self._owned.get(owner, ()))

    def alloc(self, n: int, owner) -> list[int]:
        """Acquire ``n`` pages for ``owner``; all-or-nothing."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PagesExhausted(n, len(self._free))
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        return pages

    def free_owner(self, owner) -> list[int]:
        """Release every page ``owner`` holds (no-op for unknown owners)."""
        pages = self._owned.pop(owner, [])
        self._free.extend(pages)
        return pages

    def check(self) -> None:
        """Invariant audit: no page double-owned, none both free and owned,
        none leaked."""
        owned = [p for pages in self._owned.values() for p in pages]
        owned_set = set(owned)
        if len(owned) != len(owned_set):
            raise AssertionError(f"page owned twice: {sorted(owned)}")
        free_set = set(self._free)
        if len(self._free) != len(free_set):
            raise AssertionError("free list holds duplicates")
        if owned_set & free_set:
            raise AssertionError(
                f"pages both free and owned: {sorted(owned_set & free_set)}")
        universe = set(range(self.first, self.first + self.total))
        if owned_set | free_set != universe:
            raise AssertionError(
                f"pages leaked: {sorted(universe - owned_set - free_set)}")


def pages_for(depth: int, page_size: int) -> int:
    """Pages needed to hold ``depth`` KV rows."""
    return -(-depth // page_size)


@dataclasses.dataclass
class PagedKV:
    """Device page pools plus the host-side page table of one engine.

    ``k`` / ``v``: (L, num_pages, page_size, KVH, D), layer-stacked like the
    dense cache.  ``table``: host (slots, max_pages) int32, logical page ->
    physical page, 0 = the reserved null page."""
    k: torch.Tensor
    v: torch.Tensor
    table: np.ndarray
    page_size: int

    @classmethod
    def build(cls, cfg: ModelConfig, *, slots: int, max_len: int,
              num_pages: int, page_size: int, device: torch.device,
              dtype: torch.dtype | None = None) -> "PagedKV":
        dtype = dtype or getattr(torch, cfg.compute_dtype)
        shape = (cfg.num_layers, num_pages, page_size,
                 cfg.num_kv_heads, cfg.head_dim_)
        max_pages = pages_for(max_len, page_size)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   table=np.zeros((slots, max_pages), np.int32),
                   page_size=page_size)

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    def cache(self) -> dict:
        """The cache dict the layer loop consumes (paged leaves)."""
        return {"k": self.k, "v": self.v}

    def device_table(self) -> torch.Tensor:
        return torch.as_tensor(self.table, dtype=torch.long).to(self.k.device)

    def map_slot(self, slot: int, pages: list[int]) -> None:
        """Point ``slot``'s logical pages at ``pages`` (in logical order)."""
        self.table[slot, :] = 0
        self.table[slot, :len(pages)] = pages

    def extend_slot(self, slot: int, pages: list[int],
                    start_logical: int) -> None:
        self.table[slot, start_logical:start_logical + len(pages)] = pages

    def clear_slot(self, slot: int) -> None:
        self.table[slot, :] = 0

    def insert(self, slot: int, pages: list[int], k_rows: torch.Tensor,
               v_rows: torch.Tensor) -> None:
        """Prefill-insert: write ``k_rows`` / ``v_rows`` (L, S, KVH, D), one
        request's freshly prefilled KV, into the pool at the pages' physical
        rows in logical order, and map the slot's table."""
        s = k_rows.shape[1]
        if s > len(pages) * self.page_size:
            raise ValueError(f"{s} rows > {len(pages)} pages "
                             f"x {self.page_size}")
        logical = np.arange(s)
        phys = (np.asarray(pages, np.int64)[logical // self.page_size]
                * self.page_size + logical % self.page_size)
        idx = torch.as_tensor(phys).to(self.k.device)
        for pool, rows in ((self.k, k_rows), (self.v, v_rows)):
            l, p, page, kvh, d = pool.shape
            pool.view(l, p * page, kvh, d)[:, idx] = rows.to(pool.dtype)
        self.map_slot(slot, pages)

    def zero_pages(self, pages: list[int]) -> None:
        """Zero page contents: a quarantined slot's KV may be non-finite,
        and a later occupant's p @ V contracts every row (0 * NaN = NaN)."""
        if pages:
            idx = torch.as_tensor(pages, dtype=torch.long).to(self.k.device)
            self.k[:, idx] = 0
            self.v[:, idx] = 0
