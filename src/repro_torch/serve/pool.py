"""The page allocator behind the paged KV cache (the port of
``repro.serve.pool.PagePool``; pure Python, a copy of the reference's).

Host-side and deliberately dumb: pages are interchangeable fixed-size
units of the device pool (`repro_torch.models.cache.PagedLayout`), so
allocation is a free list — O(1) alloc/free, no compaction, no copying.
The only waste a paged cache can have is internal fragmentation (the
unused tail of each sequence's last page, at most ``page_size - 1``
tokens per sequence).

Pages are refcounted: ``alloc`` hands out pages at refcount 1, ``ref``
adds sharers, ``free`` drops a reference and recycles the page when the
last one goes.  The sharer the reference has, ``PrefixCache``, waits
with chunked prefill (ROADMAP A11).

Page ids below ``reserved`` (default 1) are never handed out: physical
page 0 is the scratch page inactive decode slots write into
(`repro_torch.models.cache.SCRATCH_PAGE`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class PagePool:
    """Refcounted free-list allocator over ``num_pages`` pages of
    ``page_size`` token slots each."""

    def __init__(self, num_pages: int, page_size: int, *, reserved: int = 1,
                 bytes_per_page: int = 0):
        if num_pages <= reserved:
            raise ValueError(f"pool needs > {reserved} pages, got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.reserved = int(reserved)
        # device bytes one page pins across every paged pool (values +
        # per-token scales when quantized) — 0 when the caller doesn't
        # track bytes; makes `stats` bytes-aware
        self.bytes_per_page = int(bytes_per_page)
        # LIFO free list: recently freed pages are reused first (their
        # pool rows are warm)
        self._free: List[int] = list(range(num_pages - 1, reserved - 1, -1))
        self._ref: Dict[int, int] = {}      # page -> refcount (>0 = live)
        self.total_allocs = 0               # cumulative pages handed out

    # -- alloc / free -------------------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages at refcount 1, or None if the pool can't satisfy
        the request (callers keep the request waiting — never a partial
        grant)."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.total_allocs += n
        return pages

    def ref(self, pages: Sequence[int]) -> None:
        """Add one reference to each page (a new sharer)."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"ref of unallocated page {p}")
        for p in pages:
            self._ref[p] += 1

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page returns to the free list
        when its last reference goes.  Validates the WHOLE batch before
        touching any state: a double free (page already on the free
        list), a foreign/reserved page id, or more intra-call duplicates
        than the page has references raises ValueError with the free
        list intact — never half-applied."""
        need: Dict[int, int] = {}
        for p in pages:
            need[p] = need.get(p, 0) + 1
        for p, n in need.items():
            have = self._ref.get(p)
            if have is None:
                if 0 <= p < self.reserved:
                    raise ValueError(f"free of reserved page {p}")
                raise ValueError(f"double free / foreign page {p}")
            if n > have:
                raise ValueError(
                    f"page {p} freed {n} times but holds {have} refs")
        for p, n in need.items():
            self._ref[p] -= n
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)

    # -- accounting ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Distinct live pages — a page shared by N requests counts ONCE."""
        return len(self._ref)

    @property
    def shared_pages(self) -> int:
        return sum(1 for c in self._ref.values() if c > 1)

    @property
    def capacity_tokens(self) -> int:
        """Token slots the usable (non-reserved) pool holds."""
        return (self.num_pages - self.reserved) * self.page_size

    def stats(self, used_tokens: Optional[int] = None) -> Dict[str, float]:
        """Occupancy snapshot.  ``used_tokens`` (the live *physical* cache
        rows — shared rows counted once, known to the scheduler) adds the
        internal-fragmentation rate: the fraction of *allocated* slots
        holding no token."""
        out = {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "free_pages": self.free_pages,
            "used_pages": self.used_pages,
            "shared_pages": self.shared_pages,
            "utilization": self.used_pages / max(self.num_pages
                                                 - self.reserved, 1),
        }
        if self.bytes_per_page:
            out["page_bytes"] = self.bytes_per_page
            out["pool_bytes"] = ((self.num_pages - self.reserved)
                                 * self.bytes_per_page)
            out["used_bytes"] = self.used_pages * self.bytes_per_page
        if used_tokens is not None:
            alloc_tokens = self.used_pages * self.page_size
            out["used_tokens"] = int(used_tokens)
            out["internal_fragmentation"] = (
                1.0 - used_tokens / alloc_tokens if alloc_tokens else 0.0)
        return out
