"""Paged KV prefix pool: fixed-size pages in one preallocated device arena,
a free-list allocator, and a radix trie of copy-on-write-shared prefix KV.
The host logic is a copy of the JAX package's
``workloads/serving/kv_manager.py`` (PagePool, PrefixTrie, PagedKVStore,
plain layout), cut to what the paged loop calls.

- **PagePool**: a free list plus per-page refcounts. A page is never
  handed out twice and returns to the free list exactly when its refcount
  hits zero. Shared pages are never written in place; ``cow()`` is the
  explicit claim primitive.
- **PrefixTrie**: a radix trie over page-sized token chunks, one KV page
  per node, one root per adapter id. ``match`` returns shared pages with a
  reference held, so eviction can never free a page someone still reads;
  eviction is LRU over leaves.
- **PagedKVStore**: the arena tensors behind both, from
  ``LlamaModel.init_paged_arena``.

Thread-safety: nothing here locks. The engine serializes every call, and
every launch that touches the arena, under its ``_prefix_lock``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable."""


class PagePool:
    """Free-list page allocator with refcounts. Host bookkeeping only — a
    page id indexes the arena's page axis."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = n_pages
        # LIFO free list: recently freed pages are reused first
        self._free = list(range(n_pages - 1, -1, -1))
        self._refs = [0] * n_pages

    def alloc(self) -> int:
        """One free page at refcount 1; PoolExhausted when none is free."""
        if not self._free:
            raise PoolExhausted(f"all {self.n_pages} KV pages in use")
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def ref(self, page: int) -> None:
        if self._refs[page] <= 0:
            raise ValueError(f"ref of free page {page}")
        self._refs[page] += 1

    def unref(self, page: int) -> bool:
        """Drop one reference; True when this freed the page."""
        r = self._refs[page] - 1
        if r < 0:
            raise ValueError(f"unref of free page {page}")
        self._refs[page] = r
        if r == 0:
            self._free.append(page)
            return True
        return False

    def cow(self, page: int) -> tuple[int, bool]:
        """Copy-on-write claim: the exclusive owner keeps the page (False);
        a shared page swaps for a fresh allocation (True — the caller
        copies the payload) and the share is released."""
        if self._refs[page] <= 0:
            raise ValueError(f"cow of free page {page}")
        if self._refs[page] == 1:
            return page, False
        fresh = self.alloc()
        self.unref(page)
        return fresh, True

    def refcount(self, page: int) -> int:
        return self._refs[page]

    @property
    def free_count(self) -> int:
        return len(self._free)


@dataclasses.dataclass
class _Node:
    """One page-sized chunk of a cached prefix; the trie holds exactly one
    pool reference per node (dropped on eviction)."""
    chunk: tuple
    page: int
    parent: Optional["_Node"]
    children: dict = dataclasses.field(default_factory=dict)
    last_used: int = 0


@dataclasses.dataclass
class MatchResult:
    pages: list          # matched page ids in prompt order, ONE REF HELD EACH
    matched_tokens: int  # pages * page_tokens


class PrefixTrie:
    """Radix trie over page-sized token chunks; one root per adapter id."""

    def __init__(self, pool: PagePool, page_tokens: int):
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.pool = pool
        self.page_tokens = page_tokens
        self._roots: dict[int, dict] = {}
        # flat registry for LRU scans, keyed by id() so eviction is O(1)
        self._nodes: dict[int, _Node] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def _chunks(self, tokens: list, n: int):
        t = self.page_tokens
        return [tuple(tokens[i * t:(i + 1) * t]) for i in range(n)]

    def match(self, adapter_id: int, tokens: list) -> MatchResult:
        """Longest full-page prefix of ``tokens`` in the trie, capped so at
        least one prompt token remains to compute (its logits pick the
        first generated token). Every returned page carries one extra
        reference; the caller must ``release`` it."""
        self._clock += 1
        max_chunks = max(0, (len(tokens) - 1) // self.page_tokens)
        node_map = self._roots.get(adapter_id, {})
        pages: list[int] = []
        for chunk in self._chunks(tokens, max_chunks):
            node = node_map.get(chunk)
            if node is None:
                break
            node.last_used = self._clock
            self.pool.ref(node.page)
            pages.append(node.page)
            node_map = node.children
        return MatchResult(pages, len(pages) * self.page_tokens)

    def release(self, pages: list) -> None:
        for p in pages:
            self.pool.unref(p)

    def insert_ready(self, adapter_id: int, tokens: list,
                     pages: list) -> int:
        """Cache the full pages of ``tokens`` whose KV already sits in the
        arena pages the caller owns (``pages[i]`` backs chunk i). Each
        adopted node takes its own reference, so the caller's references
        stay the caller's to release. Chunks already present dedup through
        the walk. Returns pages adopted."""
        self._clock += 1
        want = min(len(pages), len(tokens) // self.page_tokens)
        node_map = self._roots.setdefault(adapter_id, {})
        parent: Optional[_Node] = None
        depth = 0
        chunks = self._chunks(tokens, want)
        for chunk in chunks:
            node = node_map.get(chunk)
            if node is None:
                break
            node.last_used = self._clock
            parent, node_map, depth = node, node.children, depth + 1
        added = 0
        for i, chunk in enumerate(chunks[depth:]):
            page = pages[depth + i]
            self.pool.ref(page)
            node = _Node(chunk=chunk, page=page, parent=parent,
                         last_used=self._clock)
            node_map[chunk] = node
            self._nodes[id(node)] = node
            parent, node_map = node, node.children
            added += 1
        return added

    def _evict_lru(self) -> int:
        """Drop the least-recently-used LEAF (its children would orphan
        otherwise). The pool frees the page only if no reader still holds
        it. Returns 1, or 0 when the trie has no leaf."""
        victim: Optional[_Node] = None
        for node in self._nodes.values():
            if node.children:
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return 0
        owner = (victim.parent.children if victim.parent is not None
                 else self._roots_containing(victim))
        owner.pop(victim.chunk, None)
        del self._nodes[id(victim)]
        self.pool.unref(victim.page)
        return 1

    def _roots_containing(self, node: _Node) -> dict:
        for root in self._roots.values():
            if root.get(node.chunk) is node:
                return root
        return {}

    def shared_pages(self) -> int:
        """Pages serving more than one cached sequence or reader."""
        return sum(1 for n in self._nodes.values()
                   if n.children or self.pool.refcount(n.page) > 1)


class PagedKVStore:
    """The device arena behind PagePool/PrefixTrie. ``arena`` is the dict
    ``LlamaModel.init_paged_arena`` builds, every section paged as
    (L, n_pages + 1, T, ...), the last page being the model's write sink:
    (L, n_pages + 1, T, Hkv, D) K/V sections (with (L, n_pages + 1, T, Hkv)
    scales when int8) for dense attention, or for MLA the headless latent
    sections c (L, n_pages + 1, T, r) and kr (L, n_pages + 1, T, dr) (with
    (L, n_pages + 1, T) scales when int8). Only axes 1 and 2 are checked,
    so any layout pages. The arena is updated in place by the model steps
    (the JAX store's arena was donated through each jitted step instead);
    every launch that touches it runs under the engine's prefix lock."""

    def __init__(self, n_pages: int, page_tokens: int, arena: dict):
        for name, a in arena.items():
            if a.shape[1] != n_pages + 1 or a.shape[2] != page_tokens:
                raise ValueError(f"arena section {name} {tuple(a.shape)} "
                                 f"does not hold {n_pages} pages of "
                                 f"{page_tokens} tokens plus the sink")
        self.page_tokens = page_tokens
        self.pool = PagePool(n_pages)
        self.trie = PrefixTrie(self.pool, page_tokens)
        self.arena = arena

    @property
    def page_bytes(self) -> int:
        """Device bytes one page pins across all sections and layers."""
        return sum(a.element_size() * a.numel() // a.shape[1]
                   for a in self.arena.values())

    def match(self, adapter_id: int, tokens: list) -> MatchResult:
        return self.trie.match(adapter_id, tokens)

    def alloc_run(self, n: int) -> list[int]:
        """``n`` private pages (refcount 1 each), evicting LRU trie leaves
        as needed. All or nothing: on exhaustion the partial run is
        released and PoolExhausted raised."""
        pages: list[int] = []
        try:
            for _ in range(n):
                try:
                    pages.append(self.pool.alloc())
                except PoolExhausted:
                    if not self.trie._evict_lru():
                        raise
                    pages.append(self.pool.alloc())
        except PoolExhausted:
            for p in pages:
                self.pool.unref(p)
            raise
        return pages

    def release(self, pages: list) -> None:
        self.trie.release(pages)

    def insert_ready(self, adapter_id: int, tokens: list,
                     pages: list) -> int:
        return self.trie.insert_ready(adapter_id, tokens, pages)

    def stats(self) -> dict:
        return {"pages_total": self.pool.n_pages,
                "pages_free": self.pool.free_count,
                "pages_shared": self.trie.shared_pages(),
                "nodes": len(self.trie)}
