"""Host-side page accounting for the block-paged KV cache.

The port's own copy of ``repro.serving.paged`` (host-only, numpy-only),
with the same semantics. The device side
(``repro_torch.models.transformer.PagedCache``) holds physical page
POOLS plus a per-row page table; everything about which physical page
backs which logical page of which row is decided HERE, on the host, by
``PageAllocator`` — a free list, per-page refcounts, and a chained
prefix-hash index that lets N requests sharing a prompt prefix map their
leading logical pages onto ONE physical copy.

Sharing rules (why this is safe without device-side locks):

* Only FULL prompt pages are ever registered for sharing. The KV content
  of logical page i is a pure function of prompt tokens ``[0, (i+1)*ps)``
  (causal attention), so two requests whose prompts agree on that range
  can alias the page. Decode writes land at a row's current length —
  monotonically ≥ the prompt length — so full prompt pages are never
  written again; shared prefix pages are read-only for their lifetime.
* The LAST prompt token is never matched away (``m_cap`` below): its
  forward pass produces the logits that seed generation, so every
  admission computes a non-empty suffix.
* ``fork`` (best-of-N sampling) shares ALL of a row's pages including
  the partial tail that decode DOES write into. The copy-on-write
  barrier (``writable_page``, called by the batcher before each decode
  round) detects refcount > 1 on the page about to be written and moves
  the writer onto a fresh copy first.

Physical page 0 is reserved as the NULL page and never allocated: a
freed row's table is all zeros, so the inert +1-per-round decode writes
of free rows land in page 0 instead of a page some other row now owns.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


class PagesExhausted(RuntimeError):
    """The free list cannot cover an allocation. TRANSIENT for admission
    (pages free as active rows complete — requeue and retry); the batcher
    treats it as permanent only when no active row will ever release
    pages."""


@dataclasses.dataclass
class AdmissionPlan:
    """What ``PageAllocator.admit`` decided for one request.

    ``pages`` is the row's full logical→physical map (index i = logical
    page i); the first ``n_shared`` entries alias already-populated
    prefix pages, so the engine only has to run ``extend_row`` over
    ``suffix`` — the tokens from ``start_len`` on."""

    row: int
    pages: List[int]
    n_shared: int
    start_len: int          # n_shared * page_size
    suffix: np.ndarray      # prompt[start_len:]; never empty


class PageAllocator:
    """Free list + refcounts + prefix-sharing index over a physical pool.

    Args:
      n_pages: physical pages in the device pool (page 0 = null; the
        allocatable supply is ``n_pages - 1``).
      page_size: tokens per page (must match the device cache).
      max_pages: logical pages addressable per row (the page table's
        second dim); ``max_pages * page_size`` is a row's max_len.
    """

    def __init__(self, n_pages: int, page_size: int, max_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 physical pages (page 0 is "
                             "the reserved null page)")
        if page_size <= 0 or max_pages <= 0:
            raise ValueError("page_size and max_pages must be positive")
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_pages = max_pages
        self.free_list: List[int] = list(range(n_pages - 1, 0, -1))
        # refcount-0 pages whose prefix-index entries are KEPT: a
        # completed request's prompt pages stay matchable (warm prefix
        # cache) until allocation pressure evicts them, oldest first.
        self.reclaimable: "OrderedDict[int, None]" = OrderedDict()
        self.refcounts: List[int] = [0] * n_pages
        self.rows: Dict[int, List[int]] = {}
        # chained prefix hash: key_i = (key_{i-1}, tokens of page i);
        # a key maps to the physical page holding that prefix page.
        self._index: Dict[tuple, int] = {}
        self._page_keys: Dict[int, List[tuple]] = {}

    # -- introspection --------------------------------------------------

    @property
    def n_free(self) -> int:
        """Allocatable pages: truly free + reclaimable (warm cache)."""
        return len(self.free_list) + len(self.reclaimable)

    @property
    def n_live(self) -> int:
        """Distinct physical pages currently referenced by ≥ 1 row."""
        return sum(1 for c in self.refcounts if c > 0)

    def refcount(self, page: int) -> int:
        return self.refcounts[page]

    def _take_page(self) -> int:
        """One allocatable page: the free list first, then the OLDEST
        reclaimable page (evicting its prefix-index entries — it is
        about to be overwritten)."""
        if self.free_list:
            return self.free_list.pop()
        page, _ = self.reclaimable.popitem(last=False)
        for key in self._page_keys.pop(page, []):
            self._index.pop(key, None)
        return page

    # -- admission ------------------------------------------------------

    def _prefix_chain(self, prompt) -> list:
        """Chained keys of every FULL page of ``prompt``, in order."""
        ps = self.page_size
        keys, key = [], None
        for i in range(len(prompt) // ps):
            key = (key, tuple(int(t) for t in prompt[i * ps:(i + 1) * ps]))
            keys.append(key)
        return keys

    def admit(self, row: int, prompt, max_new_tokens: int) -> AdmissionPlan:
        """Plan admission of ``prompt`` (+ room for ``max_new_tokens``)
        into ``row``: match the longest registered prefix, allocate fresh
        pages for the rest, register this prompt's full pages for future
        sharers. Raises ValueError if the request can NEVER fit a row
        (permanent) and :class:`PagesExhausted` if the free list is
        currently short (transient)."""
        if row in self.rows:
            raise ValueError(f"row {row} already holds pages — free it "
                             "before re-admitting")
        ps = self.page_size
        total = len(prompt) + max_new_tokens
        n_logical = -(-total // ps)  # ceil
        if n_logical > self.max_pages:
            raise ValueError(
                f"request needs {n_logical} pages ({len(prompt)} prompt + "
                f"{max_new_tokens} new tokens @ page_size={ps}) but rows "
                f"address at most {self.max_pages}")
        chain = self._prefix_chain(prompt)
        # never match the page holding the last prompt token: its logits
        # seed generation, so at least one suffix token must be computed.
        m_cap = (len(chain) - 1 if len(prompt) % ps == 0 else len(chain))
        shared: List[int] = []
        for key in chain[:m_cap]:
            phys = self._index.get(key)
            if phys is None:
                break
            shared.append(phys)
        n_fresh = n_logical - len(shared)
        # matched pages sitting in the reclaim pool (their owner already
        # completed — the warm prefix cache) must be revived BEFORE fresh
        # allocation so _take_page can't evict them out from under us
        revive = [p for p in shared if self.refcounts[p] == 0]
        avail = len(self.free_list) + len(self.reclaimable) - len(revive)
        if n_fresh > avail:
            raise PagesExhausted(
                f"row {row} needs {n_fresh} fresh pages, only {avail} "
                f"allocatable")
        for p in revive:
            self.reclaimable.pop(p, None)
        for p in shared:
            self.refcounts[p] += 1
        fresh = [self._take_page() for _ in range(n_fresh)]
        for p in fresh:
            self.refcounts[p] = 1
        pages = shared + fresh
        self.rows[row] = pages
        # register every full prompt page under its chain key (shared
        # prefix pages are already registered; idempotent for them)
        for i, key in enumerate(chain):
            if key not in self._index:
                self._index[key] = pages[i]
                self._page_keys.setdefault(pages[i], []).append(key)
        start_len = len(shared) * ps
        return AdmissionPlan(row=row, pages=pages, n_shared=len(shared),
                             start_len=start_len,
                             suffix=np.asarray(prompt[start_len:],
                                               np.int32))

    # -- fork / copy-on-write -------------------------------------------

    def fork(self, src: int, dst: int) -> List[int]:
        """Alias ALL of ``src``'s pages into ``dst`` (best-of-N: N rows
        continue from one prefill at zero KV copy cost). The shared
        partial tail page is what :meth:`writable_page` COWs on first
        divergent write."""
        if dst in self.rows:
            raise ValueError(f"row {dst} already holds pages")
        pages = list(self.rows[src])
        for p in pages:
            self.refcounts[p] += 1
        self.rows[dst] = pages
        return pages

    def writable_page(self, row: int, pos: int
                      ) -> Optional[Tuple[int, int]]:
        """Copy-on-write barrier: make the page holding logical position
        ``pos`` of ``row`` exclusively owned before a write.

        Returns None when the row already owns it (the common case —
        refcount 1). Otherwise allocates a fresh page, repoints the row's
        map at it, and returns ``(src, dst)`` — the CALLER must copy page
        ``src``'s device contents to ``dst`` (``Engine.cow_copy_page``)
        and reinstall the row's table before the next dispatch."""
        pages = self.rows[row]
        phys = pages[pos // self.page_size]
        if self.refcounts[phys] == 1:
            return None
        if not self.free_list and not self.reclaimable:
            raise PagesExhausted(
                f"copy-on-write for row {row} needs a free page; size the "
                "pool with headroom for forked rows")
        dst = self._take_page()
        self.refcounts[dst] = 1
        self.refcounts[phys] -= 1
        pages[pos // self.page_size] = dst
        return phys, dst

    # -- release --------------------------------------------------------

    def free(self, row: int) -> List[int]:
        """Release ``row``'s pages: decref each. A page reaching
        refcount 0 goes to the RECLAIM pool if it is prefix-indexed (its
        content stays matchable — the warm prefix cache — until
        allocation pressure evicts it, oldest first) and straight to the
        free list otherwise (partial tail pages, COW copies). Returns
        the pages that reached refcount 0."""
        recycled = []
        for p in self.rows.pop(row):
            self.refcounts[p] -= 1
            if self.refcounts[p] == 0:
                if p in self._page_keys:
                    self.reclaimable[p] = None
                else:
                    self.free_list.append(p)
                recycled.append(p)
        return recycled
