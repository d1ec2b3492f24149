"""KV page handoff between serving engines on the CPU: the port's engines
among themselves, and across the two packages, on the same f32 weights.

- torch -> torch, monolithic and streamed, through the wire codec and
  through the device rung (``device_push`` between two engines of this
  process): the adopted pages equal the exporter's bit for bit, the
  adopting engine then prefills only the sub-page tail (one paged chunk),
  and its greedy tokens equal a unified engine's that prefilled the same
  prompt itself (the same path: cached pages, then the tail);
- JAX engine -> torch engine and torch -> JAX on the f32 tiny llama, its
  int8 arena, and a tiny DeepSeek with its dense prefix (``c_pre``/
  ``kr_pre``): each package adopts the other's blob and the adopting
  engine decodes the unified engine's greedy tokens; ``section_spec``
  equals the JAX store's;
- a refused adoption (truncated, another model, another layout, another
  page size, a torn stream, a device run of the wrong shape) leaves the
  pool's free list and every refcount as they were, and counts a failure;
- a head-sharded arena (tensor mesh of 2 in one process) exports the
  single-device layout: equal to the unsharded store's export, adoptable
  by an unsharded engine;
- the directory publishes: the port's ``prefix_key`` equals the JAX
  package's, an engine publishes its runs' keys, and a failed beat's
  publishes re-queue.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.fleet import prefix_directory as jdir
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.fleet import prefix_directory as pdir
from k8s_runpod_kubelet_tpu_torch.fleet.device_transfer import (
    DeviceTransferBus, device_push)
from k8s_runpod_kubelet_tpu_torch.fleet.handoff import (
    HandoffError, deserialize_pages, serialize_chunk_frame, serialize_pages)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.engine import \
    host_sections
from k8s_runpod_kubelet_tpu_torch.workloads.serving.kv_manager import \
    PagedKVStore

TIMEOUT = 120
T = 8
LLAMA = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                          n_heads=4, n_kv_heads=2, mlp_dim=128,
                          max_seq_len=256, dtype=jnp.float32,
                          param_dtype=jnp.float32)
DEEPSEEK = jllama.tiny_mla(vocab_size=128, embed_dim=64, n_layers=3,
                           n_heads=4, n_kv_heads=4, head_dim=16,
                           mla_latent_dim=32, mla_rope_dim=8, mlp_dim=48,
                           max_seq_len=256, n_experts=4, n_experts_per_tok=2,
                           n_shared_experts=2, router_norm_topk=False,
                           n_dense_prefix=1, dense_prefix_mlp_dim=112,
                           dtype=jnp.float32, param_dtype=jnp.float32)
SHARED = [((i * 37) % 120) + 1 for i in range(24)]   # three pages


def _prompt(seed: int, n: int = 11) -> list:
    rng = np.random.default_rng(seed)
    return SHARED + [int(t) for t in rng.integers(1, 128, n)]


def _sc(**kw) -> dict:
    base = dict(slots=2, max_prefill_len=32, cache_len=128,
                max_new_tokens=8, kv_page_tokens=T)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def trees():
    """The llama tree from the JAX init, and the DeepSeek tree drawn with
    numpy (the router decisive, as ``test_torch_deepseek_engine.py``)."""
    rng = np.random.default_rng(20261018)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(DEEPSEEK, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        name = str(path[-1].key)
        if name.endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        scale = 1.0 if name == "router" else 0.08
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return {"llama": (LLAMA, jax.tree_util.tree_map(
                np.asarray, jax_init_params(LLAMA, jax.random.PRNGKey(3)))),
            "deepseek": (DEEPSEEK, jax.tree_util.tree_map_with_path(
                leaf, shapes, is_leaf=lambda s: isinstance(s, tuple)))}


def _port(trees, model="llama", mesh=None, **kw) -> ServingEngine:
    jcfg, tree = trees[model]
    cfg = config_from_jax(jcfg, torch.float32)
    return ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                         ServingConfig(**_sc(**kw)), device="cpu",
                         mesh=mesh).start()


def _jax(trees, model="llama", **kw) -> JaxServingEngine:
    jcfg, tree = trees[model]
    return JaxServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**_sc(**kw))).start()


def _tokens(engine, prompt) -> list:
    return engine.submit(prompt).result(timeout=TIMEOUT)["tokens"]


def _unified(engine, prompt) -> list:
    """A unified engine's tokens along the adopting engine's path: the
    prompt once to cache its pages, then again from them."""
    engine.submit(prompt, max_new_tokens=1).result(timeout=TIMEOUT)
    return _tokens(engine, prompt)


def _pool_state(engine) -> tuple:
    store = engine._kv_store
    return (sorted(store.pool._free), list(store.pool._refs), len(store.trie))


def _leak_free(engine) -> bool:
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    return (store.pool.free_count + len(nodes) == store.pool.n_pages
            and all(store.pool.refcount(n.page) == 1 for n in nodes))


def _wait_idle(engine):
    deadline = time.monotonic() + TIMEOUT
    while engine.active_slots or engine.queue_depth:
        assert time.monotonic() < deadline, "engine did not go idle"
        time.sleep(0.01)


def _cached_pages(engine, prompt) -> dict:
    """The arena payload of every cached full page of ``prompt``, in the
    single-device layout."""
    store = engine._kv_store
    with engine._prefix_lock:
        m = store.match_full(0, prompt)
        try:
            return {k: v.clone() for k, v in
                    store.export_pages(m.pages).items()}
        finally:
            store.release(m.pages)


def _stream_over_wire(src, dst, prompt) -> dict:
    """``serve_main``'s streamed hop without the HTTP: each fragment the
    export emits is copied to the host, framed and fed to the adopter."""
    sid, last = "s-" + str(len(prompt)), {}

    def emit(frag):
        payload = b""
        if frag["sections"]:
            sections, words = host_sections(frag["sections"], frag["ready"],
                                            src.device)
            payload = serialize_pages(frag["tokens"], T, sections,
                                      model=src.cfg.name, dtypes=words)
        last.update(dst.adopt_handoff_chunk(serialize_chunk_frame(
            sid, frag["seq"], payload, final=frag["final"],
            total_tokens=frag.get("total_tokens"))))

    out = src.export_handoff_stream(prompt, emit)
    assert last["final"] and last["pages"] == out["pages"]
    return out


HOPS = ("wire", "device", "wire_streamed", "device_streamed")


@pytest.mark.parametrize("hop", HOPS)
def test_torch_to_torch_hop_adopts_the_exporters_pages(trees, hop):
    streamed = hop.endswith("streamed")
    prefill_kw = {"serving_chunk_tokens": T} if streamed else {}
    src, dst = _port(trees, **prefill_kw), _port(trees)
    uni = _port(trees, **prefill_kw)
    try:
        prompt = _prompt(1)
        # a cached prefix on the exporter streams before any compute
        _tokens(src, SHARED + [5, 6])
        n_full = len(prompt) // T
        if hop == "wire":
            dst.adopt_handoff(src.export_handoff(prompt)["blob"])
        elif hop == "wire_streamed":
            out = _stream_over_wire(src, dst, prompt)
            assert out["matched_tokens"] == len(SHARED)
            assert out["chunks"] >= 2
        else:
            bus = DeviceTransferBus()
            bus.register("http://decode", dst, "proc:test")
            out = device_push(src, "http://decode", prompt,
                              domain="proc:test", bus=bus)
            assert (out["path"], out["streamed"], out["pages"]) == \
                ("device", streamed, n_full)
            for eng in (src, dst):
                assert eng.metrics.get_counter(
                    "tpu_serving_kv_handoff_device_runs") == 1
        assert dst.metrics.get_counter(
            "tpu_serving_kv_handoff_pages") == n_full
        mine, theirs = _cached_pages(dst, prompt), _cached_pages(src, prompt)
        assert set(mine) == {"k", "v"}
        for name in mine:
            assert mine[name].shape[1] == n_full
            assert torch.equal(mine[name], theirs[name])
        chunks0 = dst.counters["paged_prefill_chunks"]
        tokens0 = dst.counters["paged_prefill_tokens"]
        got = _tokens(dst, prompt)
        assert dst.counters["paged_prefill_chunks"] - chunks0 == 1
        assert dst.counters["paged_prefill_tokens"] - tokens0 == \
            len(prompt) - (len(prompt) - 1) // T * T
        assert got == _unified(uni, prompt)
        for eng in (src, dst):
            _wait_idle(eng)
            assert _leak_free(eng)
            assert eng.handoff_inflight == 0
        assert src.handoffs_total == 1
        assert src.debug_snapshot()["handoffs_total"] == 1
    finally:
        for eng in (src, dst, uni):
            eng.stop()


LAYOUTS = {"f32": ("llama", {}),
           "kv_int8": ("llama", {"quantize_kv_int8": True}),
           "deepseek": ("deepseek", {})}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_handoffs_cross_between_the_packages(trees, layout):
    model, kw = LAYOUTS[layout]
    jeng = _jax(trees, model, **kw)
    port, uni = _port(trees, model, **kw), _port(trees, model, **kw)
    try:
        spec = port._kv_store.section_spec()
        with jeng._prefix_lock:
            assert spec == jeng._kv_store.section_spec()
        if model == "deepseek":
            assert {"c_pre", "kr_pre"} <= set(spec)
        # JAX exports, the port adopts
        a = _prompt(2)
        out = jeng.export_handoff(a)
        res = port.adopt_handoff(out["blob"])
        assert res["pages"] == out["pages"] == len(a) // T
        want = _unified(uni, a)
        assert _tokens(port, a) == want
        assert jeng.submit(a).result(timeout=TIMEOUT)["tokens"] == want
        # the port exports, JAX adopts
        b = _prompt(3, 14)
        out = port.export_handoff(b)
        res = jeng.adopt_handoff(out["blob"])
        assert res["pages"] == len(b) // T
        assert jeng.submit(b).result(timeout=TIMEOUT)["tokens"] == \
            _unified(uni, b)
        _wait_idle(port)
        assert _leak_free(port)
    finally:
        jeng.stop()
        port.stop()
        uni.stop()


def _torn_stream(src, dst, prompt):
    frames = []

    def emit(frag):
        sections, words = ({}, {}) if not frag["sections"] else \
            host_sections(frag["sections"], frag["ready"], src.device)
        payload = (serialize_pages(frag["tokens"], T, sections,
                                   model=src.cfg.name, dtypes=words)
                   if sections else b"")
        frames.append(serialize_chunk_frame(
            "torn", frag["seq"], payload, final=frag["final"],
            total_tokens=frag.get("total_tokens")))

    src.export_handoff_stream(prompt, emit)
    dst.adopt_handoff_chunk(frames[0])
    # a lost middle frame: the final's count disagrees
    dst.adopt_handoff_chunk(serialize_chunk_frame(
        "torn", 1, b"", final=True, total_tokens=len(prompt) // T * T))


REFUSALS = ("truncated", "other_model", "other_layout", "page_size",
            "torn_stream", "device_geometry", "device_model")


@pytest.mark.parametrize("case", REFUSALS)
def test_a_refused_adoption_leaves_the_pool_as_it_was(trees, case):
    src = _port(trees, serving_chunk_tokens=T if case == "torn_stream"
                else 0, **({"quantize_kv_int8": True}
                           if case == "other_layout" else {}),
                **({"kv_page_tokens": 2 * T} if case == "page_size" else {}))
    dst = _port(trees)
    try:
        _tokens(dst, _prompt(9))   # cached pages the refusal must not touch
        _wait_idle(dst)
        before = _pool_state(dst)
        prompt = _prompt(4)
        with pytest.raises((HandoffError, ValueError)):
            if case == "torn_stream":
                _torn_stream(src, dst, prompt)
            elif case.startswith("device"):
                out = src.export_handoff_device(prompt)
                sections = out["sections"]
                if case == "device_geometry":
                    sections = {**sections, "v": sections["v"][..., :8]}
                dst.adopt_handoff_device(
                    out["tokens"], sections,
                    model="other" if case == "device_model" else src.cfg.name)
            else:
                blob = src.export_handoff(prompt)["blob"]
                if case == "truncated":
                    blob = blob[:len(blob) // 2]
                elif case == "other_model":
                    header, sections = deserialize_pages(blob)
                    blob = serialize_pages(header["tokens"], T, sections,
                                           model="other")
                dst.adopt_handoff(blob)
        assert _pool_state(dst) == before
        assert dst.metrics.get_counter("tpu_serving_kv_handoff_failures") >= 1
        assert dst.metrics.get_counter("tpu_serving_kv_handoff_pages") == 0
        assert _leak_free(dst)
    finally:
        src.stop()
        dst.stop()


def test_a_sharded_arena_exports_the_single_device_layout(trees):
    # the store alone: a run adopted into a sharded arena exports as it
    # came, equal to the unsharded store's export
    rng = np.random.default_rng(5)
    run = {"k": torch.from_numpy(rng.standard_normal((2, 3, T, 4, 6))
                                 .astype(np.float32)),
           "k_scale": torch.from_numpy(rng.standard_normal((2, 3, T, 4))
                                       .astype(np.float32))}
    one = PagedKVStore(6, T, {"k": torch.zeros(2, 7, T, 4, 6),
                              "k_scale": torch.zeros(2, 7, T, 4)})
    two = PagedKVStore(6, T, {"k": torch.zeros(4, 7, T, 2, 6),
                              "k_scale": torch.zeros(4, 7, T, 2)}, shards=2)
    assert one.section_spec() == two.section_spec() == {
        "k": ("float32", (4, 6)), "k_scale": ("float32", (4,))}
    tokens = list(range(3 * T))
    for store in (one, two):
        assert store.adopt(0, tokens, run) == (3, 0)
    for store in (one, two):
        m = store.match_full(0, tokens)
        out = store.export_pages(m.pages)
        store.release(m.pages)
        for name in run:
            assert torch.equal(out[name], run[name])
    # the engines: a tensor mesh of 2 in one process, its arena
    # head-sharded; an unsharded engine adopts its run and decodes the
    # unified tokens
    tp = _port(trees, mesh=make_mesh(MeshConfig(data=1, tensor=2)))
    dst, uni = _port(trees), _port(trees)
    try:
        assert tp._arena_shards == 2
        assert tp._kv_store.section_spec() == dst._kv_store.section_spec()
        prompt = _prompt(6)
        dst.adopt_handoff(tp.export_handoff(prompt)["blob"])
        mine, theirs = _cached_pages(dst, prompt), _cached_pages(tp, prompt)
        for name in mine:
            assert torch.equal(mine[name], theirs[name])
        assert _tokens(dst, prompt) == _unified(uni, prompt)
    finally:
        for eng in (tp, dst, uni):
            eng.stop()


def test_prefix_keys_and_publishes(trees):
    rng = np.random.default_rng(8)
    for adapter in ("", "a1"):
        for page in (1, 8, 16):
            tokens = [int(t) for t in rng.integers(0, 50000, 70)]
            assert pdir.prefix_key_chain(tokens, page, adapter) == \
                jdir.prefix_key_chain(tokens, page, adapter)
            assert pdir.prefix_key(tokens, page, adapter) == \
                jdir.prefix_key(tokens, page, adapter)
    assert pdir.prefix_key([1, 2], 8) == "" == jdir.prefix_key([1, 2], 8)
    eng = _port(trees)
    woken = []
    eng.prefix_publish_hook = lambda: woken.append(1)
    try:
        prompt = _prompt(7)
        _tokens(eng, prompt)
        pubs = eng.take_prefix_publishes()
        n = len(prompt) // T
        assert pubs == [{"key": jdir.prefix_key(prompt[:n * T], T),
                         "pages": n, "model": eng.cfg.name, "adapter": ""}]
        assert woken and eng.take_prefix_publishes() == []
        eng.requeue_prefix_publishes(pubs)
        assert eng.take_prefix_publishes() == pubs
    finally:
        eng.stop()
