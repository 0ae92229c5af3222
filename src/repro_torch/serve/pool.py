"""The page allocator and the prefix-page index behind the paged KV cache
(the port of ``repro.serve.pool``; pure Python, a copy of the reference's).

Host-side and deliberately dumb: pages are interchangeable fixed-size
units of the device pool (`repro_torch.models.cache.PagedLayout`), so
allocation is a free list — O(1) alloc/free, no compaction, no copying.
The only waste a paged cache can have is internal fragmentation (the
unused tail of each sequence's last page, at most ``page_size - 1``
tokens per sequence).

Pages are refcounted: ``alloc`` hands out pages at refcount 1, ``ref``
adds sharers, ``free`` drops a reference and recycles the page when the
last one goes.  A page is writable only while its refcount is 1: a writer
into a shared page copies it first (the scheduler's copy-on-write).

`PrefixCache` (also a copy of the reference's) is the hash-chained index
of committed prefix pages: a page is committed once it is full (every one
of its ``page_size`` positions written by prefill), keyed by the chain
``(parent page, the page's token ids)``.  A prompt that walks the same
chain maps its block table onto the same physical pages and skips that
part of its prefill.  The cache holds one reference on every committed
page; pages only the cache holds are evictable, LRU first.

Page ids below ``reserved`` (default 1) are never handed out: physical
page 0 is the scratch page inactive decode slots write into
(`repro_torch.models.cache.SCRATCH_PAGE`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


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


# ---------------------------------------------------------------------------
# prefix cache — hash-chained index of committed prefix pages
# ---------------------------------------------------------------------------

_ROOT = -1  # chain parent of a prompt's first page


class PrefixCache:
    """Index of committed (full, immutable) prefix pages.

    A committed page is keyed by ``(parent page id, its page_size token
    ids)`` — the chain key — so two prompts share a page only when every
    token up to and including that page matches.  `match` walks the
    chain for whole pages, then checks the parent's committed children
    for a *partial* tail overlap (shared up to the first divergent
    token; the sharer must copy-on-write before appending into it).

    The cache holds ONE pool reference per committed page.  Pages whose
    only holder is the cache (refcount 1) are evictable, LRU-first; a
    page with committed children is never evicted before they are (the
    chain key of a child embeds its parent's id).
    """

    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.ps = int(page_size)
        self._chain: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._key_of: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._kids: Dict[int, List[int]] = {}     # parent -> committed kids
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._key_of)

    def tokens_of(self, page: int) -> Tuple[int, ...]:
        return self._key_of[page][1]

    def pages(self) -> List[int]:
        """Every committed page id (the cache holds one ref on each)."""
        return list(self._key_of)

    # -- lookup -------------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest committed prefix of ``tokens``.  Returns (pages,
        matched token count); the caller is handed ONE new reference per
        returned page (it must `pool.free` them when done).  The last
        returned page may be a *partial* match (matched stops inside
        it) — the caller must copy-on-write before writing into it.
        Callers cap ``tokens`` at prompt-1 so the final-token logits are
        always recomputed."""
        toks = [int(t) for t in tokens]
        pages: List[int] = []
        parent, i = _ROOT, 0
        while i + self.ps <= len(toks):
            pg = self._chain.get((parent, tuple(toks[i:i + self.ps])))
            if pg is None:
                break
            pages.append(pg)
            parent, i = pg, i + self.ps
        # partial tail: the best child sharing >= 1 leading token
        best, best_n = None, 0
        if i < len(toks):
            tail = toks[i:]
            for pg in self._kids.get(parent, ()):
                ptoks = self._key_of[pg][1]
                n = 0
                for a, b in zip(ptoks, tail):
                    if a != b:
                        break
                    n += 1
                if n > best_n:
                    best, best_n = pg, n
        if best is not None:
            pages.append(best)
            i += best_n
        if pages:
            self.pool.ref(pages)
            for pg in pages:
                self._lru.move_to_end(pg)
            self.hits += 1
            self.hit_tokens += i
        else:
            self.misses += 1
        return pages, i

    # -- commit -------------------------------------------------------------

    def commit(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index the full pages of a just-prefilled prompt: page ``j``
        holds tokens ``[j*ps, (j+1)*ps)`` of ``tokens``.  Only whole
        pages commit (``len(tokens) // ps`` of them — a partial last
        page is still mutable).  Already-indexed chain keys are kept
        (first writer wins; an identical prefix prefilled concurrently
        into different pages stays private to its request and is freed
        normally).  The cache takes one pool reference per newly indexed
        page.  Returns the number of pages committed."""
        toks = [int(t) for t in tokens]
        parent, committed = _ROOT, 0
        for j in range(len(toks) // self.ps):
            pg = int(pages[j])
            key = (parent, tuple(toks[j * self.ps:(j + 1) * self.ps]))
            cur = self._chain.get(key)
            if cur is not None:
                parent = cur
                continue
            if pg in self._key_of:
                # page already committed under another chain (can't
                # happen while immutable — defensive)
                parent = pg
                continue
            self._chain[key] = pg
            self._key_of[pg] = key
            self._kids.setdefault(parent, []).append(pg)
            self.pool.ref([pg])
            self._lru[pg] = None
            self._lru.move_to_end(pg)
            parent = pg
            committed += 1
        return committed

    # -- eviction -----------------------------------------------------------

    def evict(self, n: int) -> int:
        """Drop up to ``n`` committed pages nobody references but the
        cache (refcount 1), LRU-first, childless-first (a parent only
        becomes evictable once its committed children are gone).
        Returns how many pages were returned to the pool."""
        dropped = 0
        progress = True
        while dropped < n and progress:
            progress = False
            for pg in list(self._lru):
                if self._kids.get(pg):
                    continue
                if self.pool.refcount(pg) != 1:
                    continue
                self._drop(pg)
                dropped += 1
                progress = True
                if dropped >= n:
                    break
        return dropped

    def _drop(self, pg: int) -> None:
        parent, ptoks = self._key_of.pop(pg)
        del self._chain[(parent, ptoks)]
        self._kids.pop(pg, None)
        if parent in self._kids:
            self._kids[parent].remove(pg)
        self._lru.pop(pg, None)
        self.pool.free([pg])
        self.evictions += 1

    # -- accounting ---------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {
            "committed_pages": len(self._key_of),
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
        }
