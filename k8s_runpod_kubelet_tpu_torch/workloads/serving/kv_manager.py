"""Paged KV prefix pool: fixed-size pages in one preallocated device arena,
a free-list allocator, and a radix trie of copy-on-write-shared prefix KV.
The host logic is a copy of the JAX package's
``workloads/serving/kv_manager.py`` (PagePool, PrefixTrie, PagedKVStore,
plain layout, DensePrefixStore), cut to what the two serving loops
call.

- **PagePool**: a free list plus per-page refcounts. A page is never
  handed out twice and returns to the free list exactly when its refcount
  hits zero. Shared pages are never written in place; ``cow()`` is the
  explicit claim primitive.
- **PrefixTrie**: a radix trie over page-sized token chunks, one KV page
  per node, one root per adapter id. ``match`` returns shared pages with a
  reference held, so eviction can never free a page someone still reads;
  eviction is LRU over unpinned leaves (``register_prefix`` pins its
  path).
- **DensePrefixStore**: registered prefixes as whole single-request
  caches, for the contiguous loop (ring and mixed caches cannot page, and
  with the prefix cache off there is no arena): longest prefix wins,
  adapter variants fill lazily and are LRU-bounded.
- **PagedKVStore**: the arena tensors behind both, from
  ``LlamaModel.init_paged_arena``, and the copies between the arena and a
  dense single-request cache (``LlamaModel.init_cache``): ``gather``
  (matched pages into a cache), ``insert`` (a cache's full pages into the
  trie) and ``fill_pages`` (a slot's private tail). A page copy is an
  ``index_copy_`` over the page axis. For the KV handoff between
  replicas, ``section_spec``, ``export_pages`` and ``adopt`` move a page
  run out of the arena and into another one in the single-device layout
  (the JAX store's, so runs cross between the packages).

Thread-safety: nothing here locks. The engine serializes every call, and
every launch that touches the arena, under its ``_prefix_lock``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ...fleet.handoff import dtype_name


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
    pinned: bool = False      # on a register_prefix path: never evicted
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
        max_chunks = max(0, (len(tokens) - 1) // self.page_tokens)
        return self._match_chunks(adapter_id, tokens, max_chunks)

    def match_full(self, adapter_id: int, tokens: list) -> MatchResult:
        """Like ``match`` but without the one-token-remaining cap: every
        full page of ``tokens`` the trie holds, reference held. A slot
        bound from a dense cache references these pages read-only."""
        return self._match_chunks(adapter_id, tokens,
                                  len(tokens) // self.page_tokens)

    def _match_chunks(self, adapter_id: int, tokens: list,
                      max_chunks: int) -> MatchResult:
        self._clock += 1
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

    def insert(self, adapter_id: int, tokens: list,
               write_pages: Callable[[list, int], None],
               pin: bool = False) -> tuple[int, int]:
        """Cache every full page of ``tokens`` not already present.
        ``write_pages(page_ids, start_chunk)`` copies the KV payload into
        the arena before the nodes become matchable. Evicts LRU leaves
        when the pool runs dry, never a node on the path being extended;
        with nothing evictable it caches what it could. Returns (pages
        added, pages evicted)."""
        self._clock += 1
        want = len(tokens) // self.page_tokens
        node_map = self._roots.setdefault(adapter_id, {})
        parent: Optional[_Node] = None
        chunks = self._chunks(tokens, want)
        depth = 0
        path: list[_Node] = []
        for chunk in chunks:
            node = node_map.get(chunk)
            if node is None:
                break
            node.last_used = self._clock
            if pin:
                node.pinned = True
            parent, node_map, depth = node, node.children, depth + 1
            path.append(node)
        evicted = 0
        new_nodes: list[_Node] = []
        protect = set(id(n) for n in path)
        for chunk in chunks[depth:]:
            try:
                page = self.pool.alloc()
            except PoolExhausted:
                evicted += self._evict_lru(protect)
                try:
                    page = self.pool.alloc()
                except PoolExhausted:
                    break  # nothing evictable: cache what we could
            node = _Node(chunk=chunk, page=page, parent=parent, pinned=pin,
                         last_used=self._clock)
            new_nodes.append(node)
            protect.add(id(node))
            parent = node
        if new_nodes:
            # payload first, visibility second
            write_pages([n.page for n in new_nodes], depth)
            node_map = (self._roots[adapter_id] if not path
                        else path[-1].children)
            for node in new_nodes:
                node_map[node.chunk] = node
                self._nodes[id(node)] = node
                node_map = node.children
        return len(new_nodes), evicted

    def insert_ready(self, adapter_id: int, tokens: list, pages: list,
                     pin: bool = False) -> int:
        """Cache the full pages of ``tokens`` whose KV already sits in the
        arena pages the caller owns (``pages[i]`` backs chunk i). Each
        adopted node takes its own reference, so the caller's references
        stay the caller's to release. Chunks already present dedup through
        the walk. ``pin`` marks every node of the path, those already
        there included, as never evicted. Returns pages adopted."""
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
            if pin:
                node.pinned = True
            parent, node_map, depth = node, node.children, depth + 1
        added = 0
        for i, chunk in enumerate(chunks[depth:]):
            page = pages[depth + i]
            self.pool.ref(page)
            node = _Node(chunk=chunk, page=page, parent=parent, pinned=pin,
                         last_used=self._clock)
            node_map[chunk] = node
            self._nodes[id(node)] = node
            parent, node_map = node, node.children
            added += 1
        return added

    def _evict_lru(self, protect: frozenset = frozenset()) -> int:
        """Drop the least-recently-used unpinned LEAF (its children would
        orphan otherwise) whose id() is not in ``protect``. The pool frees
        the page only if no reader still holds it. Returns 1, or 0 when
        the trie has no such leaf."""
        victim: Optional[_Node] = None
        for node in self._nodes.values():
            if node.children or node.pinned or id(node) in protect:
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

    def drop_adapter(self, adapter_id: int) -> int:
        """Forget an adapter's whole subtree (its weights were replaced, so
        its cached prefix KV is stale), pinned nodes too. The pool frees a
        page only once no reader still holds it. Returns the nodes
        dropped."""
        root = self._roots.pop(adapter_id, None)
        if root is None:
            return 0
        dropped = 0
        stack = list(root.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            del self._nodes[id(node)]
            self.pool.unref(node.page)
            dropped += 1
        return dropped

    def adapter_roots(self) -> list[int]:
        """The adapter ids with a root (0 is the base model)."""
        return sorted(self._roots)

    def shared_pages(self) -> int:
        """Pages serving more than one cached sequence or reader."""
        return sum(1 for n in self._nodes.values()
                   if n.children or self.pool.refcount(n.page) > 1)


class DensePrefixStore:
    """Registered prefixes for the contiguous loop (the JAX
    ``DensePrefixStore``): a ring or mixed cache cannot page (position p
    lives in ring slot p % R and early positions are overwritten by
    design), so the faithful snapshot of a prefix is the whole
    single-request cache at its end. Longest registered prefix wins;
    per-adapter variants fill lazily (adapter deltas reach K/V) and are
    LRU-bounded by ``max_adapter_variants``, while base variants stay
    pinned. A variant is whatever the engine stores (its (last logits,
    cache)); the engine copies a cache before appending to it. Not
    thread-safe (the engine's lock)."""

    @dataclasses.dataclass
    class _Entry:
        tokens: list
        variants: dict
        lru: dict = dataclasses.field(default_factory=dict)

    def __init__(self, max_adapter_variants: int):
        self.max_adapter_variants = max_adapter_variants
        self._entries: list[DensePrefixStore._Entry] = []
        self._clock = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, tokens: list):
        """Longest registered prefix of ``tokens`` (entries are kept
        longest-first), or None."""
        return next((e for e in self._entries
                     if len(e.tokens) <= len(tokens)
                     and tokens[:len(e.tokens)] == e.tokens), None)

    def has(self, tokens: list) -> bool:
        return any(e.tokens == tokens for e in self._entries)

    def add(self, tokens: list, base_variant) -> None:
        self._entries.append(self._Entry(tokens=list(tokens),
                                         variants={0: base_variant}))
        self._entries.sort(key=lambda e: -len(e.tokens))  # longest first

    def touch(self, entry, adapter_id: int) -> None:
        self._clock += 1
        entry.lru[adapter_id] = self._clock

    def put_variant(self, entry, adapter_id: int, var) -> bool:
        """Store a lazily built adapter variant (False if a racing fill
        won); evicts LRU adapter variants past the budget. Base variants
        were registered explicitly and stay."""
        if adapter_id in entry.variants:
            return False
        entry.variants[adapter_id] = var
        self.touch(entry, adapter_id)
        cap = self.max_adapter_variants
        while True:
            ad_vars = [(e.lru.get(aid, 0), e, aid)
                       for e in self._entries
                       for aid in e.variants if aid != 0]
            if len(ad_vars) <= cap:
                return True
            _, victim, aid = min(ad_vars, key=lambda t: t[0])
            del victim.variants[aid]
            victim.lru.pop(aid, None)

    def drop_adapter(self, adapter_id: int) -> None:
        for e in self._entries:
            e.variants.pop(adapter_id, None)
            e.lru.pop(adapter_id, None)

    def snapshot(self) -> list:
        return [{"tokens": len(e.tokens),
                 "adapter_variants": len(e.variants)}
                for e in self._entries]


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """(L, S, Hkv, ...) positions of every kv head -> (N·L, S, Hkv/N, ...),
    shard s's layers first at s·L holding heads s·h .. (s+1)·h (x itself
    when ``n`` is 1): a head-sharded arena's or contiguous cache's
    layout."""
    if n == 1:
        return x
    return x.unflatten(2, (n, -1)).movedim(2, 0).flatten(0, 1)


def _join_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``_split_heads``."""
    if n == 1:
        return x
    return x.unflatten(0, (n, -1)).movedim(0, 2).flatten(2, 3)


class PagedKVStore:
    """The device arena behind PagePool/PrefixTrie. ``arena`` is the dict
    ``LlamaModel.init_paged_arena`` builds, every section paged as
    (L, n_pages + 1, T, ...), the last page being the model's write sink:
    (L, n_pages + 1, T, Hkv, D) K/V sections (with (L, n_pages + 1, T, Hkv)
    scales when int8) for dense attention, or for MLA the headless latent
    sections c (L, n_pages + 1, T, r) and kr (L, n_pages + 1, T, dr) (with
    (L, n_pages + 1, T) scales when int8). Only axes 1 and 2 are checked,
    so any layout pages. ``shards`` > 1 is a head-sharded arena of a
    tensor-parallel model in one process, (N·L, n_pages + 1, T, Hkv/N, ...)
    (``LlamaModel.init_paged_arena``): the copies to and from a dense cache
    move each shard's heads to and from their place among the cache's Hkv.
    The arena is updated in place by the model steps (the JAX store's arena
    was donated through each jitted step instead); every launch that
    touches it runs under the engine's prefix lock."""

    def __init__(self, n_pages: int, page_tokens: int, arena: dict,
                 shards: int = 1):
        for name, a in arena.items():
            if a.shape[1] != n_pages + 1 or a.shape[2] != page_tokens:
                raise ValueError(f"arena section {name} {tuple(a.shape)} "
                                 f"does not hold {n_pages} pages of "
                                 f"{page_tokens} tokens plus the sink")
        self.page_tokens = page_tokens
        self.shards = shards
        self.pool = PagePool(n_pages)
        self.trie = PrefixTrie(self.pool, page_tokens)
        self.arena = arena

    @property
    def page_bytes(self) -> int:
        """Device bytes one page pins across all sections and layers (and
        all shards of a head-sharded arena)."""
        return sum(a.element_size() * a.numel() // a.shape[1]
                   for a in self.arena.values())

    @property
    def page_bytes_per_shard(self) -> int:
        """The bytes of a page that one shard holds: its heads of a
        head-sharded arena, all of a replicated one."""
        return self.page_bytes // self.shards

    def _to_dense(self, frag: torch.Tensor) -> torch.Tensor:
        """Pages (L', n, T, ...) of a section -> (L, n·T, ...) positions
        with every kv head in place (a sharded arena's shards side by side
        on the head axis)."""
        return _join_heads(frag.flatten(1, 2), self.shards)

    def _from_dense(self, src: torch.Tensor, n_pages: int) -> torch.Tensor:
        """The inverse of ``_to_dense``: (L, n·T, ...) positions -> pages
        (L', n, T, ...) of the arena's layout."""
        return _split_heads(src, self.shards).unflatten(
            1, (n_pages, self.page_tokens))

    def _cache_shards(self, single: dict, name: str) -> int:
        """The kv-head shards of a single-request cache's section (the
        model's ``cache_head_shards`` layout: (N·L, 1, S, Hkv/N, ...))."""
        layers = self.arena[name].shape[0] // self.shards
        return single[name].shape[0] // layers

    def match(self, adapter_id: int, tokens: list) -> MatchResult:
        return self.trie.match(adapter_id, tokens)

    def match_full(self, adapter_id: int, tokens: list) -> MatchResult:
        """Every cached full page of ``tokens``, no final-token cap: the
        page-table source of a slot bound from a dense cache."""
        return self.trie.match_full(adapter_id, tokens)

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

    def gather(self, pages: list, single: dict) -> dict:
        """Matched pages -> the single-request cache ``single`` (a fresh
        ``LlamaModel.init_cache(1, ...)``, filled in place and returned)
        with positions 0 .. len(pages) * T and ``index`` set. The caller
        still owns the match references. A head-sharded cache takes each
        shard's heads, whatever the arena's layout."""
        n, t = len(pages), self.page_tokens
        ids = torch.tensor(pages, dtype=torch.long,
                           device=single["index"].device)
        for name, a in self.arena.items():
            frag = a.index_select(1, ids)               # (L, n, T, ...)
            single[name][:, 0, :n * t] = _split_heads(
                self._to_dense(frag), self._cache_shards(single, name))
        single["index"].fill_(n * t)
        return single

    def fill_pages(self, single: dict, pages: list, start_tok: int) -> None:
        """Copy positions start_tok .. start_tok + len(pages) * T of a
        single-request cache (whole or head-sharded) into ``pages`` (the
        caller owns their references); positions past the cache's length
        copy as zeros (masked by attention, overwritten by decode writes),
        so the last page never reads a clamped slice."""
        n, t = len(pages), self.page_tokens
        for name, a in self.arena.items():
            ids = torch.tensor(pages, dtype=torch.long, device=a.device)
            src = single[name][:, 0, start_tok:start_tok + n * t]
            if src.shape[1] < n * t:
                pad = src.new_zeros((src.shape[0], n * t - src.shape[1])
                                    + tuple(src.shape[2:]))
                src = torch.cat([src, pad], dim=1)
            a.index_copy_(1, ids, self._from_dense(
                _join_heads(src, self._cache_shards(single, name)), n))

    def insert(self, adapter_id: int, tokens: list, single: dict,
               pin: bool = False) -> tuple[int, int]:
        """Cache ``tokens``' full pages from a prefilled single-request
        cache (KV for positions 0 .. len(tokens) present). Returns (pages
        added, pages evicted)."""
        t = self.page_tokens
        return self.trie.insert(
            adapter_id, tokens,
            lambda ids, start_chunk: self.fill_pages(single, ids,
                                                     start_chunk * t),
            pin=pin)

    def insert_ready(self, adapter_id: int, tokens: list, pages: list,
                     pin: bool = False) -> int:
        return self.trie.insert_ready(adapter_id, tokens, pages, pin=pin)

    # -- KV handoff: a page run out of this arena, or into it ----------------

    def section_spec(self) -> dict:
        """{name: (dtype name, per-page trailing shape)}: what a handoff
        run must match to adopt here (``fleet/handoff.py``'s
        ``expect_sections``). The single-device layout, equal to the JAX
        store's for the same config: a sharded arena's heads are counted
        whole, and the sink page never shows."""
        spec = {}
        for name, a in self.arena.items():
            tail = list(a.shape[3:])
            if self.shards > 1:
                tail[0] *= self.shards    # the kv-head axis
            spec[name] = (dtype_name(a.dtype), tuple(int(s) for s in tail))
        return spec

    def export_pages(self, pages: list) -> dict:
        """Fresh copies of the run's payload, {name: (L, n, T, ...)} in the
        single-device layout (a sharded arena's shards side by side on the
        head axis, as JAX gathers to a replicated layout). They stay valid
        while later steps write the arena in place, so the caller may copy
        them to the host outside the engine's prefix lock; the caller holds
        the pages' references while this runs, under that lock. Every
        section in one index_select (and one head interleave when
        sharded): nothing compiles per run length, so unlike the JAX
        store there is no pow2 padding."""
        n, t = len(pages), self.page_tokens
        out = {}
        for name, a in self.arena.items():
            ids = torch.tensor(pages, dtype=torch.long, device=a.device)
            frag = a.index_select(1, ids)
            if self.shards > 1:
                frag = self._to_dense(frag).unflatten(1, (n, t))
            out[name] = frag
        return out

    # the streamed export's per-chunk form: export_pages as it is (the JAX
    # store pads it to a pow2 bucket for its jit)
    export_run = export_pages

    def section_tensor(self, name: str, a) -> torch.Tensor:
        """A run's section ``a`` (a tensor, or a numpy array from the wire
        codec, bfloat16 as its raw words) as a tensor on the arena's device
        in its dtype: raw words are viewed, never converted, so the bytes
        adopted are the bytes exported."""
        like = self.arena[name]
        if not isinstance(a, torch.Tensor):
            arr = np.ascontiguousarray(a)
            if arr.dtype == np.uint16:   # words of a dtype numpy lacks
                arr = arr.view(np.int16)
            with warnings.catch_warnings():
                # a wire blob's arrays are read-only views of its bytes;
                # the tensor is only read (copied to the device below)
                warnings.simplefilter("ignore", UserWarning)
                a = torch.from_numpy(arr)
        if a.dtype != like.dtype:
            if a.element_size() != like.element_size():
                raise ValueError(f"section {name}: {a.dtype} cannot hold "
                                 f"{like.dtype} words")
            a = a.view(like.dtype)
        return a.to(like.device)

    def adopt(self, adapter_id: int, tokens: list, sections: dict
              ) -> tuple[int, int]:
        """Insert a handoff run into the trie and the arena.
        ``sections[name]`` is the (L, n, T, ...) payload of the run's pages
        in prompt order (tensors, or numpy arrays from the wire codec),
        ``tokens`` the n·T token ids they hold, both already checked
        against ``section_spec``. Pages already cached dedup through the
        trie walk; only the missing suffix allocates, and its payload is
        written before the nodes become matchable. Every section is on the
        device before the trie is touched, so a refused run leaves the
        pool as it was. Returns (pages added, pages evicted)."""
        n, t = len(tokens) // self.page_tokens, self.page_tokens
        dense = {}
        for name, a in sections.items():
            a = self.section_tensor(name, a)
            if a.dim() < 3 or a.shape[1] != n or a.shape[2] != t:
                raise ValueError(f"section {name} {tuple(a.shape)} is not "
                                 f"(L, {n}, {t}, ...)")
            dense[name] = a.flatten(1, 2)        # (L, n·T, ...)

        def write(ids: list, start_chunk: int):
            k = len(ids)
            for name, arena in self.arena.items():
                src = dense[name][:, start_chunk * t:(start_chunk + k) * t]
                arena.index_copy_(
                    1, torch.tensor(ids, dtype=torch.long,
                                    device=arena.device),
                    self._from_dense(src, k))

        return self.trie.insert(adapter_id, list(tokens), write)

    def stats(self) -> dict:
        # evictable: unpinned trie pages only the trie references, which
        # an eviction returns to the free list now (the fleet reporter's
        # KV headroom: free + evictable)
        evictable = sum(
            1 for node in self.trie._nodes.values()
            if not node.pinned and self.pool.refcount(node.page) == 1)
        return {"pages_total": self.pool.n_pages,
                "pages_free": self.pool.free_count,
                "pages_shared": self.trie.shared_pages(),
                "pages_evictable": evictable,
                "nodes": len(self.trie),
                "pinned": sum(1 for n in self.trie._nodes.values()
                              if n.pinned),
                "adapters": self.trie.adapter_roots()}
