"""Paged KV cache: fixed-size pages, a free-list allocator, per-slot tables.

Counterpart of ``dmlc_tpu/generate/kvcache.py``. Paging carves the KV pool
into fixed-size pages and binds them to slots on demand through an int32
page table, so capacity is a fleet of pages shared by whatever mix of
requests is resident.

Layout:

- ``k_pages`` / ``v_pages``: [num_layers, num_pages, page_size, H, Dh]
  tensors on the engine's device. One page id spans every layer, so there
  is one allocator and one table, not num_layers of each.
- **page 0 is the reserved scratch page**: never allocated, the write/read
  target for inactive batch rows (the decode step runs at a fixed batch
  shape; rows with no request must still index something). Garbage lands
  there and is never attended to.
- ``page_table``: int32 [max_slots, max_pages_per_slot], host-owned
  (NumPy) and shipped to the device per step. Released rows are reset to
  scratch so a stale table can never reach a recycled page.

The allocator is a plain LIFO free list under a lock: page exhaustion
raises the typed ``PagePoolExhausted``, which the slot scheduler converts
into a typed ``Overloaded`` shed at admission.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from dmlc_tpu_torch.utils.device import resolve_device

#: Page id 0 — the scratch page inactive rows point at; never allocated.
SCRATCH_PAGE = 0


class PagePoolExhausted(Exception):
    """No free pages: the caller must shed, evict, or retry later."""


class PageAllocator:
    """Free-list allocator over the page pool. Thread-safe; LIFO reuse so
    a just-released page is the next one handed out — which is exactly
    what the cross-slot-contamination tests want to stress."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved scratch)")
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # Ascending pop order (list.pop() takes the tail) keeps allocation
        # deterministic for the seeded tests.
        self._free = list(range(self.num_pages - 1, SCRATCH_PAGE, -1))
        self._held: set[int] = set()
        self.allocs = 0
        self.frees = 0
        self.exhaustions = 0

    @property
    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_total(self) -> int:
        return self.num_pages - 1  # scratch excluded

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache positions."""
        return -(-max(0, int(n_tokens)) // self.page_size)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` pages or none: a partial grant would leave the caller
        holding pages it must immediately free under the same contention."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            if n > len(self._free):
                self.exhaustions += 1
                raise PagePoolExhausted(
                    f"need {n} page(s), {len(self._free)} free "
                    f"of {self.pages_total}"
                )
            pages = [self._free.pop() for _ in range(n)]
            self._held.update(pages)
            self.allocs += n
            return pages

    def free(self, pages: list[int]) -> None:
        with self._lock:
            for p in pages:
                p = int(p)
                if p == SCRATCH_PAGE:
                    raise ValueError("page 0 is the reserved scratch page")
                if p not in self._held:
                    raise ValueError(f"double free (or foreign page): {p}")
                self._held.discard(p)
                self._free.append(p)
                self.frees += 1

    def summary(self) -> dict[str, int]:
        with self._lock:
            return {
                "pages_total": self.pages_total,
                "pages_free": len(self._free),
                "pages_held": len(self._held),
                "allocs": self.allocs,
                "frees": self.frees,
                "exhaustions": self.exhaustions,
            }


class PagedKVCache:
    """Device page pools + the host-side slot table over one allocator.

    Construction is the expensive part (it allocates the whole pool in
    device memory) and happens once per engine, never per request or per
    step. ``device=None`` is the current CUDA device and raises when there
    is none; the CPU is used only when named.
    """

    def __init__(
        self,
        *,
        num_layers: int,
        num_pages: int,
        page_size: int,
        num_heads: int,
        head_dim: int,
        max_slots: int,
        max_pages_per_slot: int,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.dtype = dtype
        self.allocator = PageAllocator(num_pages, page_size)
        shape = (num_layers, num_pages, page_size, num_heads, head_dim)
        # The pools live on the engine's device for the engine's lifetime;
        # the engine writes each step's K/V into them in place.
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        # Host-owned table/lengths; rows default to the scratch page.
        self.page_table = np.full(
            (self.max_slots, self.max_pages_per_slot), SCRATCH_PAGE, np.int32
        )
        self.lengths = np.zeros(self.max_slots, np.int32)
        self._slot_pages: dict[int, list[int]] = {}

    # ---- slot binding ---------------------------------------------------

    @property
    def max_tokens_per_slot(self) -> int:
        return self.max_pages_per_slot * self.page_size

    def bind(self, slot: int, pages: list[int]) -> None:
        """Install an allocated page run as ``slot``'s table row (pages come
        from ``allocator.alloc``, usually via a submit-time reservation)."""
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already bound")
        if len(pages) > self.max_pages_per_slot:
            raise ValueError(
                f"{len(pages)} pages exceed max_pages_per_slot="
                f"{self.max_pages_per_slot}"
            )
        self._slot_pages[slot] = list(pages)
        self.page_table[slot, :] = SCRATCH_PAGE
        self.page_table[slot, : len(pages)] = pages
        self.lengths[slot] = 0

    def grow(self, slot: int) -> None:
        """Add one page to ``slot`` (decode crossed a page boundary).
        Raises PagePoolExhausted without disturbing the slot's state."""
        pages = self._slot_pages[slot]
        if len(pages) >= self.max_pages_per_slot:
            raise PagePoolExhausted(
                f"slot {slot} at max_pages_per_slot={self.max_pages_per_slot}"
            )
        (page,) = self.allocator.alloc(1)
        pages.append(page)
        self.page_table[slot, len(pages) - 1] = page
        self.pages_needed_hw = max(getattr(self, "pages_needed_hw", 0), len(pages))

    def capacity_ok(self, slot: int, next_len: int) -> bool:
        """True when the slot's bound pages already cover ``next_len``
        cache positions (no grow needed before the next step)."""
        return len(self._slot_pages[slot]) * self.page_size >= next_len

    def release(self, slot: int) -> list[int]:
        """Recycle the slot's pages into the free list and reset its table
        row to scratch. Returns the freed page ids (tests assert reuse)."""
        pages = self._slot_pages.pop(slot, [])
        if pages:
            self.allocator.free(pages)
        self.page_table[slot, :] = SCRATCH_PAGE
        self.lengths[slot] = 0
        return pages

    def slot_pages(self, slot: int) -> list[int]:
        return list(self._slot_pages.get(slot, []))

    @property
    def pages_free(self) -> int:
        return self.allocator.pages_free
