"""The port's quantized serving path against the JAX package's, on the CPU.

- ``paged_verify_step`` on f32 ``tiny_llama`` with int4 weights and an
  int8 KV arena (and, as a parametrised case, int8 weights over an f32
  arena): the JAX-quantized tree carried across by ``params_from_jax``,
  the same tokens and page tables; logits within atol 1e-4 of JAX
  ``LlamaModel.paged_verify_step`` (f32 sums in other orders over two
  layers), the int8 pages within one step of rounding and their scales
  within 1e-5, and 16 greedy tokens identical. (An f32 difference of one
  ulp in a K row can move its int8 rounding by one step, which moves the
  logits by ~1e-3; int8 weights over an int8 arena meet such a row in
  this case, so that pairing is held by the engine test's tokens);
- ``ServingEngine(quantize_int4 / quantize_int8, quantize_kv_int8)`` gives
  the JAX ``ServingEngine``'s greedy tokens on the same f32 parameters and
  prompts (each engine quantizes its own copy), with a prefix hit and zero
  leaked pages after drain;
- rows that must be dropped (an inactive slot's stale table row, rows past
  a chunk's true length) leave every live page's int8 rows and scales
  untouched: they land on the sink page;
- the HTTP front built from ``--int4 --kv-int8`` serves on the CPU, and
  ``--int8 --int4`` is refused.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models.quant import \
    quantize_params as jax_quantize_params
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=256, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=256,
                         max_seq_len=256, dtype=jnp.float32,
                         param_dtype=jnp.float32)
T, N_PAGES, COLS = 8, 24, 8
SHARED = [((i * 37) % 120) + 1 for i in range(24)]   # three 8-token pages


@pytest.fixture(scope="module")
def tree():
    """Seeded numpy parameters in the JAX layout (norms near 1)."""
    rng = np.random.default_rng(20261016)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(JCFG, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _quantized_pair(tree, bits):
    """JAX model and quantized params; the port's, carried across."""
    jq = jax_quantize_params(JCFG, tree, bits=bits)
    cfg = config_from_jax(JCFG, torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), cfg,
                             device="cpu")
    return jllama.LlamaModel(JCFG), jq, LlamaModel(cfg, device="cpu"), params


@pytest.mark.parametrize("bits,kv_int8", [(4, True), (8, False)],
                         ids=["int4_weights_int8_arena", "int8_weights"])
def test_paged_verify_step_matches_jax(tree, bits, kv_int8):
    jmodel, jparams, model, params = _quantized_pair(tree, bits)
    jstep = jax.jit(jmodel.paged_verify_step)   # one trace per K, not eager
    kind = "q4" if bits == 4 else "q8"
    assert params["layers"]["wq"][kind].dtype == \
        (torch.uint8 if bits == 4 else torch.int8)
    assert params["lm_head"]["scale"].dtype == torch.float32
    table = np.random.default_rng(5).permutation(N_PAGES)[:2 * COLS] \
        .reshape(2, COLS).astype(np.int32)
    jarena = jmodel.init_paged_arena(N_PAGES, T, quantize=kv_int8)
    arena = model.init_paged_arena(N_PAGES, T, quantize=kv_int8)
    if kv_int8:
        assert set(arena) == {"k", "v", "k_scale", "v_scale"}
        assert arena["k"].dtype == torch.int8
        assert arena["k_scale"].shape == (2, N_PAGES + 1, T, 2)
    rng = np.random.default_rng(8)
    n_tok = np.array([21, 17], np.int32)
    toks = rng.integers(1, 128, (2, 24)).astype(np.int32)
    zero = np.zeros((2,), np.int32)
    lj, jarena = jstep(
        jparams, jnp.asarray(toks), jarena, jnp.asarray(table),
        jnp.asarray(zero), n_tokens=jnp.asarray(n_tok))
    lt, arena = model.paged_verify_step(
        params, torch.from_numpy(toks), arena, torch.from_numpy(table),
        torch.from_numpy(zero), n_tokens=torch.from_numpy(n_tok))
    lj = np.asarray(lj)
    for b, n in enumerate(n_tok):
        np.testing.assert_allclose(lt[b, :n].numpy(), lj[b, :n], atol=1e-4,
                                   rtol=0)
    # greedy decode, 16 tokens, one at a time through the verify step
    tok = np.array([lj[b, n - 1].argmax() for b, n in enumerate(n_tok)],
                   np.int32)
    lengths = n_tok.copy()
    toks_j, toks_t = [tok.tolist()], [tok.tolist()]
    tok_t = torch.from_numpy(tok)
    for _ in range(16):
        lj, jarena = jstep(
            jparams, jnp.asarray(np.array(toks_j[-1], np.int32))[:, None],
            jarena, jnp.asarray(table), jnp.asarray(lengths))
        lt, arena = model.paged_verify_step(
            params, tok_t[:, None], arena, torch.from_numpy(table),
            torch.from_numpy(lengths))
        np.testing.assert_allclose(lt[:, 0].numpy(), np.asarray(lj[:, 0]),
                                   atol=1e-4, rtol=0)
        toks_j.append(np.asarray(lj[:, 0]).argmax(-1).tolist())
        tok_t = lt[:, 0].argmax(-1).to(torch.int32)
        toks_t.append(tok_t.tolist())
        lengths = lengths + 1
    assert toks_t == toks_j
    for name in ("k", "v") if kv_int8 else ():
        diff = (arena[name][:, :N_PAGES].int().numpy()
                - np.asarray(jarena[name]).astype(np.int32))
        assert np.abs(diff).max() <= 1
        np.testing.assert_allclose(arena[f"{name}_scale"][:, :N_PAGES]
                                   .numpy(), np.asarray(
                                       jarena[f"{name}_scale"]),
                                   rtol=1e-5, atol=0)


def test_dropped_rows_leave_live_int8_pages_untouched(tree):
    _, _, model, params = _quantized_pair(tree, 4)
    gen = torch.Generator().manual_seed(1)
    arena = model.init_paged_arena(8, 4, quantize=True)
    for name, a in arena.items():   # live contents to protect
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen))
        else:
            a.copy_(torch.rand(a.shape, generator=gen) + 0.01)
    before = {k: v.clone() for k, v in arena.items()}
    # slot 0 active at position 5 (page 4, offset 1); slot 1 inactive with
    # a stale row aliasing slot 0's page
    pt = torch.tensor([[3, 4, 0, 0], [4, 4, 0, 0]], dtype=torch.int32)
    model.paged_decode_step(params, torch.tensor([5, 7], dtype=torch.int32),
                            arena, pt, torch.tensor([5, 5], dtype=torch.int32),
                            torch.tensor([True, False]))
    # a chunk of 8 rows with 3 real ones, at positions 0-2 of page 2
    model.paged_prefill_chunk_step(
        params, torch.arange(1, 9, dtype=torch.int32)[None], arena,
        torch.tensor([[2, 6, 0, 0]], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32),
        torch.tensor([3], dtype=torch.int32))
    for name, a in arena.items():
        changed = (a != before[name])
        changed = changed.reshape(a.shape[0], a.shape[1], a.shape[2], -1) \
            .any(-1).any(0)                                  # (P + 1, T)
        allowed = torch.zeros_like(changed)
        allowed[4, 1] = True          # slot 0's new row
        allowed[2, :3] = True         # the chunk's real rows
        allowed[8] = True             # the sink page
        assert not (changed & ~allowed).any(), name
        assert changed[4, 1] and changed[2, :3].all(), name


def _config(**kw):
    base = dict(slots=4, max_prefill_len=32, cache_len=128,
                max_new_tokens=12, kv_page_tokens=8, quantize_kv_int8=True)
    base.update(kw)
    return base


def _prompts():
    rng = np.random.default_rng(7)
    out = [SHARED + [int(t) for t in rng.integers(1, 128, 5)],
           SHARED + [int(t) for t in rng.integers(1, 128, 9)]]
    out += [[int(t) for t in rng.integers(1, 128, n)] for n in (3, 40)]
    return out


def _leak_free(engine) -> bool:
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    return (store.pool.free_count + len(nodes) == store.pool.n_pages
            and all(store.pool.refcount(n.page) == 1 for n in nodes))


def _drain(engine):
    engine.drain()
    wait = threading.Event()
    for _ in range(TIMEOUT * 20):
        if engine.drained:
            return
        wait.wait(0.05)
    raise AssertionError("engine did not drain")


@pytest.mark.parametrize("weights", ["int4", "int8"])
def test_quantized_engine_matches_the_jax_engine(tree, weights):
    flags = dict(quantize_int4=weights == "int4",
                 quantize_int8=weights == "int8")
    prompts = _prompts()
    jeng = JaxServingEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                            JaxServingConfig(**_config(**flags))).start()
    try:
        ref = [jeng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
    finally:
        jeng.stop()
    cfg = config_from_jax(JCFG, torch.float32)
    eng = ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                        ServingConfig(**_config(**flags)),
                        device="cpu").start()
    try:
        got = [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
               for p in prompts]
        assert eng.counters["prefix_cache_hits"] >= 1
        _drain(eng)
        assert _leak_free(eng)
        snap = eng.debug_snapshot()
        assert (snap["weights"], snap["kv"]) == (weights, "int8")
        # int8 K/V (1 byte) plus two f32 scales per (position, kv head)
        assert snap["prefix_cache"]["page_bytes"] == 2 * 2 * T * 2 * (64 + 4)
    finally:
        eng.stop()
    assert got == ref
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                      ServingConfig(quantize_int8=True, quantize_int4=True),
                      device="cpu")


def test_http_front_serves_with_int4_and_kv_int8_flags():
    args = serve_main.parse_args(
        ["--device", "cpu", "--model", "tiny", "--int4", "--kv-int8",
         "--tokenizer", "bytes", "--slots", "2", "--cache-len", "64",
         "--max-new-tokens", "4"])
    engine, tok = serve_main.build_engine(args)
    httpd = serve_main.serve(engine, port=0, tokenizer=tok, host="127.0.0.1")
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate",
            data=json.dumps({"text": "hello"}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert r.status == 200
            out = json.loads(r.read())
        assert 1 <= len(out["tokens"]) <= 4 and isinstance(out["text"], str)
        snap = engine.debug_snapshot()
        assert (snap["weights"], snap["kv"]) == ("int4", "int8")
        assert "q4" in engine.params["layers"]["w_down"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    assert serve_main.main(["--device", "cpu", "--int8", "--int4"]) == 1
