"""Paged KV-cache management: page pool allocator, prefix trie, COW forking
(``repro/serving/paging.py``, whole file).

Host-side bookkeeping for the ``kv_layout="paged"`` serving path. The device
holds one page *pool* per cache leaf: ``[num_pages, HK, page_size, D]``
int8/bf16 data, with f32 scale pools ``[num_pages, HK, page_size]`` for an
int8 cache, and every slot addresses it through a row of the page *table*
``[slots, cache_len // page_size]`` int32. Everything in this module is
plain numpy and Python run between engine ticks; the only device work it
ever causes is the rare COW page copy, which the engine applies as one
indexed copy over the pool leaves. The JAX module imports only numpy, but
importing it pulls in the JAX engine, so the port keeps this copy: same
names, the same LIFO free-list order, the same garbage page and the same
``stats()`` keys.

Three pieces:

* :class:`PageAllocator` — free-list + refcounts. ``alloc`` hands out an
  exclusive page (ref 1), ``ref``/``deref`` share and release it; a page
  returns to the free list exactly when its refcount hits zero, and a
  negative refcount (double free) raises instead of corrupting the pool.

* :class:`PrefixTrie` — radix-style prompt interning, keyed on *full-page*
  token blocks (a node per ``page_size``-token tuple). Inserting pins the
  slot's filled page under the trie's own refcount; matching at admission
  maps those pages into the new slot's table read-only (ref++), so a shared
  system prompt is prefilled once. LRU leaf eviction backs pool pressure.

* :class:`PagedKV` — the engine-facing manager tying table + allocator +
  trie together: ``admit`` (prefix match → table mapping → tail offset),
  ``ensure_writable`` (lazy alloc; COW fork when a shared page is about to
  be written), ``insert_prefix`` (intern a finished prefill), ``release``.

The **garbage page** (allocated once, never freed) backs every table entry
that maps no real content: unwritten live blocks and the engine's whole
trash-tail region. Writes diverted there collide freely — the page is never
read un-masked, so like the contiguous trash tail its content only needs to
stay finite. The **COW invariant**: a page with refcount > 1 (or pinned by
the trie) is never written through any slot's table; ``ensure_writable``
forks it first, so a reader sharing the page can never observe another
slot's writes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class PagePoolExhausted(RuntimeError):
    """No free page and nothing evictable: the caller must shed load."""


class PageAllocator:
    """Free-list page allocator with refcounts (host-side, O(1) ops)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"page pool needs >= 2 pages, got {num_pages}")
        self.num_pages = num_pages
        self.refs = np.zeros(num_pages, np.int32)
        self.free_list = list(range(num_pages - 1, -1, -1))  # pop() -> page 0 first
        self.high_water = 0

    @property
    def used(self) -> int:
        return self.num_pages - len(self.free_list)

    def alloc(self) -> int:
        if not self.free_list:
            raise PagePoolExhausted(f"all {self.num_pages} pages in use")
        page = self.free_list.pop()
        self.refs[page] = 1
        self.high_water = max(self.high_water, self.used)
        return page

    def ref(self, page: int) -> None:
        if self.refs[page] <= 0:
            raise ValueError(f"ref of free page {page}")
        self.refs[page] += 1

    def deref(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        if self.refs[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self.free_list.append(page)
            return True
        return False


@dataclasses.dataclass
class _TrieNode:
    page: int
    children: dict  # {page-token tuple: _TrieNode}
    last_used: int


class PrefixTrie:
    """Trie over full-page prompt token blocks; each node pins one page."""

    def __init__(self, allocator: PageAllocator):
        self.alloc = allocator
        self.root: dict = {}  # {token tuple: _TrieNode}
        self._clock = 0
        self.size = 0  # pinned pages

    def _keys(self, tokens: np.ndarray, page_size: int) -> list[tuple]:
        n_full = len(tokens) // page_size
        return [tuple(int(t) for t in tokens[i * page_size:(i + 1) * page_size])
                for i in range(n_full)]

    def match(self, tokens: np.ndarray, page_size: int) -> list[int]:
        """Pages of the longest interned full-page prefix (no ref taken)."""
        self._clock += 1
        pages, level = [], self.root
        for key in self._keys(tokens, page_size):
            node = level.get(key)
            if node is None:
                break
            node.last_used = self._clock
            pages.append(node.page)
            level = node.children
        return pages

    def insert(self, tokens: np.ndarray, pages: list[int],
               page_size: int) -> int:
        """Intern ``pages`` (the slot's filled pages for each full prompt
        block). An existing node keeps its original page — the two are
        bitwise-identical by the chunk-split invariant, and the slot's copy
        stays privately owned. Returns the number of newly pinned pages."""
        self._clock += 1
        added, level = 0, self.root
        for key, page in zip(self._keys(tokens, page_size), pages):
            node = level.get(key)
            if node is None:
                self.alloc.ref(page)  # the trie's own pin
                node = _TrieNode(page=page, children={},
                                 last_used=self._clock)
                level[key] = node
                self.size += 1
                added += 1
            node.last_used = self._clock
            level = node.children
        return added

    def evict_lru(self) -> bool:
        """Unpin the least-recently-used *leaf* node (children would dangle
        otherwise). Returns False when the trie is empty."""
        best: tuple | None = None  # (last_used, level, key)

        def walk(level):
            nonlocal best
            for key, node in level.items():
                if node.children:
                    walk(node.children)
                elif best is None or node.last_used < best[0]:
                    best = (node.last_used, level, key)

        walk(self.root)
        if best is None:
            return False
        _, level, key = best
        node = level.pop(key)
        self.alloc.deref(node.page)
        self.size -= 1
        return True


class PagedKV:
    """Page table + allocator + prefix trie for one ``ServingEngine``.

    ``table[slot, block]`` is the pool page backing logical cache block
    ``block`` of ``slot`` (block = seq position // page_size over the whole
    ``cache_len`` view, trash tail included). Entries at ``self.garbage``
    hold no reference; every other entry holds exactly one slot reference.
    """

    def __init__(self, *, slots: int, cache_len: int, page_size: int,
                 num_pages: int = 0, prefix_cache: bool = True):
        if cache_len % page_size:
            raise ValueError(f"cache_len {cache_len} % page_size {page_size}")
        self.page_size = page_size
        self.num_blocks = cache_len // page_size
        # auto sizing reserves full residency per slot plus the garbage page:
        # strictly more slots than pages-worth is the overcommit the caller
        # opts into with an explicit kv_num_pages.
        self.num_pages = num_pages or (slots * self.num_blocks + 1)
        self.allocator = PageAllocator(self.num_pages)
        self.garbage = self.allocator.alloc()  # permanently held
        self.table = np.full((slots, self.num_blocks), self.garbage, np.int32)
        self.prefix_cache = prefix_cache
        self.trie = PrefixTrie(self.allocator)
        self._tokens: dict[int, np.ndarray] = {}  # slot -> admitted stream
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.cow_forks = 0
        self.evictions = 0

    # ----- admission ------------------------------------------------------

    def admit(self, slot: int, tokens: np.ndarray, chunk0: int) -> int:
        """Map the longest interned prefix into ``slot`` and return the
        chunk-aligned prefill *tail start*: the engine prefills only
        ``tokens[tail_start:]``. The last prompt token is never skipped
        (its logits seed decoding), so a full-prefix hit still re-prefills
        the final ``chunk0`` tokens — into a COW fork of the shared page.
        """
        ps = self.page_size
        self._tokens[slot] = np.asarray(tokens)
        if not self.prefix_cache:
            return 0
        self.prefix_queries += 1
        pages = self.trie.match(tokens, ps)
        matched = len(pages) * ps
        tail_start = (min(matched, len(tokens) - 1) // chunk0) * chunk0
        if tail_start <= 0:
            return 0
        for b, page in enumerate(pages):
            self.allocator.ref(page)
            self.table[slot, b] = page
        self.prefix_hits += 1
        self.prefix_hit_tokens += tail_start
        return tail_start

    def insert_prefix(self, slot: int) -> int:
        """Intern the slot's finished prefill (every full prompt page) into
        the trie. Called by the engine at prefill handoff, after the tick's
        numerics guard passed — quarantined content is never interned."""
        tokens = self._tokens.get(slot)
        if tokens is None or not self.prefix_cache:
            return 0
        n_full = len(tokens) // self.page_size
        pages = [int(self.table[slot, b]) for b in range(n_full)]
        if any(p == self.garbage for p in pages):
            return 0  # divergent admission (shouldn't happen); don't intern
        return self.trie.insert(tokens, pages, self.page_size)

    # ----- write preparation (lazy alloc + COW) ---------------------------

    def _alloc(self) -> int:
        """Alloc with trie LRU eviction as the pressure valve."""
        while True:
            try:
                return self.allocator.alloc()
            except PagePoolExhausted:
                if not self.trie.evict_lru():
                    raise
                self.evictions += 1

    def ensure_writable(self, slot: int,
                        blocks: "range | list[int]") -> list[tuple[int, int]]:
        """Make every block in ``blocks`` exclusively writable by ``slot``.

        Unmapped blocks get a fresh page (no copy — the writer fills it
        before any masked read can see it); shared blocks (ref > 1, i.e.
        mapped by another slot or pinned by the trie) are COW-forked.
        Returns the (src, dst) page copy pairs the engine must apply on
        device *before* dispatching the tick. Idempotent — an exclusive
        block is a no-op, so preparing a tick twice is safe.
        Raises :class:`PagePoolExhausted` when the pool (post-eviction)
        cannot cover the request; the caller sheds the requester.
        """
        pairs: list[tuple[int, int]] = []
        for b in blocks:
            if b >= self.num_blocks:  # trash region: garbage by contract
                continue
            page = int(self.table[slot, b])
            if page == self.garbage:
                self.table[slot, b] = self._alloc()
            elif self.allocator.refs[page] > 1:
                dst = self._alloc()
                pairs.append((page, dst))
                self.table[slot, b] = dst
                self.allocator.deref(page)
                self.cow_forks += 1
        return pairs

    # ----- retirement -----------------------------------------------------

    def release(self, slot: int) -> None:
        """Drop the slot's references and reset its row to the garbage page.
        Trie-pinned pages survive (their pin is the trie's, not the slot's)."""
        for b in range(self.num_blocks):
            page = int(self.table[slot, b])
            if page != self.garbage:
                self.allocator.deref(page)
                self.table[slot, b] = self.garbage
        self._tokens.pop(slot, None)

    def free_pages(self) -> list[int]:
        return list(self.allocator.free_list)

    def stats(self) -> dict:
        a = self.allocator
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_used": a.used,
            "pages_free": len(a.free_list),
            "high_water": a.high_water,
            "utilization": a.used / a.num_pages,
            "trie_pages": self.trie.size,
            "prefix_queries": self.prefix_queries,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_queries
                                if self.prefix_queries else 0.0),
            "cow_forks": self.cow_forks,
            "evictions": self.evictions,
        }
