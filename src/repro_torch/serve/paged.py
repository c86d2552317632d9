"""Host-side page accounting for the paged KV cache.

The device side is a physical page pool per attention layer
(``init_paged_caches``) plus **one** page table shared by every paged layer
— slot positions advance uniformly across the stack, so the logical-page →
physical-page mapping is the same everywhere. This allocator owns that
table on the host (numpy; snapshotted to a device array once per engine
step) and a free-list of physical pages.

Admission cost is O(pages-touched): binding releases/claims a handful of
list entries and writes a few table cells — never a cache-tree rebuild.
Page 0 is reserved as the **trash page**: slots with no binding (inactive
lanes in the step's batch column) clamp their scatter writes to it, so the
jitted step needs no host round-trip to learn which lanes are live.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PageAllocator"]


class PageAllocator:
    """Free-list allocator over ``n_pages`` physical pages for ``n_slots``
    request slots of up to ``pages_per_slot`` logical pages each.

    Not thread-safe on its own — the engine serializes access under its
    admission lock.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 pages_per_slot: int):
        if n_pages < 2:
            raise ValueError("need at least one usable page beyond the "
                             "reserved trash page 0")
        self.page_size = page_size
        self.n_pages = n_pages
        self.pages_per_slot = pages_per_slot
        self._free = list(range(n_pages - 1, 0, -1))  # page 0 reserved
        self.table = np.full((n_slots, pages_per_slot), -1, np.int32)

    # -- binding ----------------------------------------------------------

    def ensure(self, slot: int, position: int) -> bool:
        """Bind the page covering ``position`` for ``slot`` if it isn't
        already bound. Returns False when the pool is exhausted (the caller
        stalls or sheds the slot; nothing is modified)."""
        idx = position // self.page_size
        if idx >= self.pages_per_slot:
            return False  # past the table width: stall, never IndexError
        if self.table[slot, idx] >= 0:
            return True
        if not self._free:
            return False
        self.table[slot, idx] = self._free.pop()
        return True

    def release(self, slot: int) -> int:
        """Free every page bound to ``slot``; returns how many were freed."""
        row = self.table[slot]
        bound = row[row >= 0]
        self._free.extend(int(p) for p in bound)
        row[:] = -1
        return len(bound)

    # -- accounting -------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return int((self.table >= 0).sum())

    @property
    def capacity(self) -> int:
        """Usable pages (total minus the reserved trash page)."""
        return self.n_pages - 1

    def check(self) -> None:
        """Invariants: used + free == capacity, no page double-bound, no
        bound page on the free list, page 0 never handed out."""
        bound = self.table[self.table >= 0].tolist()
        assert len(bound) == len(set(bound)), "page double-bound"
        assert 0 not in bound, "trash page bound to a slot"
        assert 0 not in self._free, "trash page on the free list"
        assert not (set(bound) & set(self._free)), "bound page on free list"
        assert len(bound) + len(self._free) == self.capacity, \
            (len(bound), len(self._free), self.capacity)
