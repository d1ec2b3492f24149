"""The port's copy of the paged KV pool and prefix trie: the invariants
``tests/test_paged_kv.py`` pins for the JAX package's, on the calls the
port keeps (``alloc_run`` + ``insert_ready`` instead of the dense
``insert`` with a write callback, which the port does not have).

- the free list never hands a page out twice, and refs balance;
- COW claims balance refcounts;
- trie match = longest common FULL-PAGE token prefix, capped so >= 1
  prompt token remains to compute;
- eviction is LRU-leaves-first and never FREES a page someone still
  references; ``alloc_run`` is all-or-nothing;
- the store's arena is the model's (P + 1 pages: the sink page included).
"""

import pytest
import torch

from k8s_runpod_kubelet_tpu_torch.models import LlamaModel, tiny_llama
from k8s_runpod_kubelet_tpu_torch.workloads.serving.kv_manager import (
    PagedKVStore, PagePool, PoolExhausted, PrefixTrie)


class TestPagePool:
    def test_never_double_allocates(self):
        pool = PagePool(8)
        got = [pool.alloc() for _ in range(8)]
        assert sorted(got) == list(range(8))
        with pytest.raises(PoolExhausted):
            pool.alloc()

    def test_unref_to_zero_frees_and_refs_balance(self):
        pool = PagePool(2)
        p = pool.alloc()
        pool.ref(p)
        assert pool.refcount(p) == 2
        assert pool.unref(p) is False
        assert pool.unref(p) is True
        assert pool.free_count == 2
        a, b = pool.alloc(), pool.alloc()
        assert sorted((a, b)) == [0, 1]

    def test_unref_below_zero_and_ref_of_free_page_raise(self):
        pool = PagePool(1)
        with pytest.raises(ValueError):
            pool.ref(0)
        p = pool.alloc()
        pool.unref(p)
        with pytest.raises(ValueError):
            pool.unref(p)

    def test_cow_exclusive_keeps_page(self):
        pool = PagePool(2)
        p = pool.alloc()
        assert pool.cow(p) == (p, False)
        assert pool.refcount(p) == 1

    def test_cow_shared_allocates_and_balances(self):
        pool = PagePool(2)
        p = pool.alloc()
        pool.ref(p)
        q, copied = pool.cow(p)
        assert copied and q != p
        assert pool.refcount(p) == 1 and pool.refcount(q) == 1
        pool.unref(p)
        pool.unref(q)
        assert pool.free_count == 2


class _Store:
    """Trie + pool with the engine's insertion path: allocate a run,
    adopt its full pages into the trie, drop the run's references."""

    def __init__(self, n_pages=16, t=4):
        self.pool = PagePool(n_pages)
        self.trie = PrefixTrie(self.pool, t)
        self.t = t

    def insert(self, tokens):
        pages = [self.pool.alloc() for _ in range(-(-len(tokens) // self.t))]
        added = self.trie.insert_ready(0, tokens, pages)
        self.trie.release(pages)
        return added


class TestPrefixTrie:
    def test_match_is_longest_common_full_page_prefix(self):
        s = _Store()
        assert s.insert(list(range(10))) == 2     # only FULL pages cached
        assert len(s.trie) == 2
        m = s.trie.match(0, list(range(10)) + [99])
        assert m.matched_tokens == 8
        s.trie.release(m.pages)
        m = s.trie.match(0, list(range(6)))
        assert m.matched_tokens == 4
        s.trie.release(m.pages)
        assert s.trie.match(0, [7, 7, 7, 7]).matched_tokens == 0

    def test_match_leaves_one_token_to_compute(self):
        s = _Store()
        s.insert(list(range(8)))
        m = s.trie.match(0, list(range(8)))
        assert m.matched_tokens == 4
        s.trie.release(m.pages)

    def test_insert_ready_shares_common_prefix_and_dedups(self):
        s = _Store()
        s.insert(list(range(8)))
        used = s.pool.n_pages - s.pool.free_count
        assert s.insert([0, 1, 2, 3, 9, 9, 9, 9]) == 1   # first page dedups
        assert s.pool.n_pages - s.pool.free_count == used + 1
        assert s.trie.shared_pages() >= 1
        # every cached page is held by exactly its trie node
        assert all(s.pool.refcount(n.page) == 1
                   for n in s.trie._nodes.values())

    def test_adapter_roots_are_distinct(self):
        s = _Store()
        toks = list(range(8))
        s.insert(toks)
        assert s.trie.match(1, toks).matched_tokens == 0
        pages = [s.pool.alloc(), s.pool.alloc()]
        assert s.trie.insert_ready(1, toks, pages) == 2
        s.trie.release(pages)
        m = s.trie.match(1, toks + [1])
        assert m.matched_tokens == 8
        s.trie.release(m.pages)

    def test_eviction_is_lru_leaf_first(self):
        s = _Store(n_pages=3, t=4)
        s.insert(list(range(8)))       # root page R + leaf A under it
        s.insert([9] * 4)              # leaf B
        assert s.pool.free_count == 0
        m = s.trie.match(0, list(range(8)) + [0])   # touch R and A
        s.trie.release(m.pages)
        assert s.trie._evict_lru() == 1
        assert s.trie.match(0, [9] * 4 + [0]).matched_tokens == 0   # B went
        m = s.trie.match(0, list(range(8)) + [0])
        assert m.matched_tokens == 8
        s.trie.release(m.pages)
        assert s.trie._evict_lru() == 1            # A (R is not a leaf)
        assert s.trie._evict_lru() == 1            # then R
        assert s.trie._evict_lru() == 0 and s.pool.free_count == 3

    def test_eviction_never_frees_a_referenced_page(self):
        s = _Store(n_pages=2, t=4)
        s.insert([1] * 4)
        s.insert([2] * 4)
        m = s.trie.match(0, [1] * 4 + [0])
        held = m.pages[0]
        store = PagedKVStore.__new__(PagedKVStore)
        store.pool, store.trie = s.pool, s.trie
        run = store.alloc_run(1)        # evicts the LRU leaf ([2] * 4)
        assert run != [held]
        # the next allocation evicts the held page's node, but the page
        # stays referenced: nothing frees, the allocation fails
        with pytest.raises(PoolExhausted):
            store.alloc_run(1)
        assert held not in s.pool._free and len(s.trie) == 0
        s.trie.release(m.pages)          # last ref: now it frees
        assert held in s.pool._free
        store.release(run)

    def test_alloc_run_is_all_or_nothing(self):
        s = _Store(n_pages=3, t=4)
        store = PagedKVStore.__new__(PagedKVStore)
        store.pool, store.trie = s.pool, s.trie
        keep = store.alloc_run(2)
        with pytest.raises(PoolExhausted):
            store.alloc_run(2)
        assert s.pool.free_count == 1
        store.release(keep)
        assert s.pool.free_count == 3


def test_store_wraps_the_model_arena_with_its_sink_page():
    cfg = tiny_llama(vocab_size=64, embed_dim=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, mlp_dim=64, max_seq_len=64,
                     dtype=torch.float32)
    model = LlamaModel(cfg, device="cpu")
    store = PagedKVStore(6, 4, model.init_paged_arena(6, 4))
    assert store.arena["k"].shape == (2, 7, 4, 2, 8)
    # K and V, all layers, one page: 2 * 2 * 4 * 2 * 8 f32 values
    assert store.page_bytes == 2 * 2 * 4 * 2 * 8 * 4
    assert store.stats()["pages_total"] == 6
    with pytest.raises(ValueError, match="sink"):
        PagedKVStore(5, 4, model.init_paged_arena(6, 4))
