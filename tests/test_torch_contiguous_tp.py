"""The port's contiguous decode loop under an in-process tensor mesh of 2,
on the CPU in f32, against the port's one-device engine and the JAX
package's engine on the same weights:

- the model level: ``init_cache``/``init_mixed_cache`` lay each K/V
  section out per shard ((N·L, B, S, Hkv/N, D), the arena's layout; shard
  s holds kv heads s·h .. (s+1)·h, the JAX ``kv_cache_pspec`` split) and
  ``prefill`` then ``verify_step`` over it give the one-device logits
  (1e-5, an int8 cache 1e-3) and, shard by shard, the one-device cache's
  heads; a control whose shard 1 reads shard 0's kv heads must miss;
- the engine: Gemma 2's mixed cache, a linear cache with the prefix cache
  off, a linear cache over the paged prefix pool (``paged_decode`` off:
  the pool's pages gather into and fill from head-sharded prefill caches),
  an int8 cache and ``speculate_k`` 2: greedy tokens identical to the
  tensor-1 port engine's and to the JAX engine's, and after the burst the
  batch cache's shard s equal to the tensor-1 cache's heads s·h ..
  (s+1)·h (f32 at 1e-5; int8 within one step, a rounding tie of
  ``_kv_quant`` may flip).
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.llama import LlamaModel
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
from k8s_runpod_kubelet_tpu_torch.parallel.sharding import shard_params
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 300
N = 2
SMALL = dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
             n_kv_heads=2, mlp_dim=128, max_seq_len=256,
             dtype=jnp.float32, param_dtype=jnp.float32)
G2 = jllama.tiny_llama(**dict(SMALL, n_layers=4), name="tiny-g2",
                       head_dim=32, sliding_window=8,
                       sliding_window_pattern=2, attn_logit_softcap=50.0,
                       query_pre_attn_scalar=64.0, post_norms=True,
                       logit_softcap=30.0)
LLAMA = jllama.tiny_llama(**SMALL)
SC = dict(slots=3, max_prefill_len=16, cache_len=256, max_new_tokens=20,
          kv_page_tokens=8)
PREFIX = [int(t) for t in np.random.default_rng(50).integers(1, 128, 20)]
# case -> (JAX config, ServingConfig fields, layout)
CASES = {
    "gemma2_mixed": (G2, {}, "mixed"),
    "llama_prefix_off": (LLAMA, dict(prefix_cache_enabled=False), "linear"),
    "linear_paged_pool": (LLAMA, dict(paged_decode=False), "linear"),
    "gemma2_kv_int8": (G2, dict(quantize_kv_int8=True), "mixed"),
    "gemma2_speculate": (G2, dict(speculate_k=2), "mixed"),
}
SECTIONS = ("k", "v", "k_scale", "v_scale", "k_l", "v_l", "k_g", "v_g",
            "k_l_scale", "v_l_scale", "k_g_scale", "v_g_scale")


def _port(jcfg, jparams):
    cfg = config_from_jax(jcfg, torch.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, params_from_jax(tree, cfg, device="cpu")


def _traffic():
    rng = np.random.default_rng(51)
    cycle = [int(t) for t in rng.integers(1, 128, 4)]
    return [PREFIX + [int(t) for t in rng.integers(1, 128, 9)], cycle * 6,
            [int(t) for t in rng.integers(1, 128, 30)]]


def _shards(cache: dict, name: str) -> torch.Tensor:
    """A head-sharded section as (N, L, ...) shard by shard."""
    t = cache[name]
    return t.view(N, -1, *t.shape[1:])


def _assert_heads(sharded: dict, whole: dict, int8: bool) -> int:
    """Shard s of every K/V section of ``sharded`` equals heads s·h ..
    (s+1)·h of ``whole``'s; returns the sections compared."""
    n = 0
    for name in SECTIONS:
        if name not in whole:
            continue
        heads = whole[name].shape[3] // N
        for s in range(N):
            got = _shards(sharded, name)[s].float()
            want = whole[name][:, :, :, s * heads:(s + 1) * heads].float()
            tol = dict(atol=1, rtol=0) if int8 and not name.endswith(
                "_scale") else dict(atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(got, want, **tol)
        n += 1
    torch.testing.assert_close(sharded["index"], whole["index"])
    if "abs_pos" in whole:
        torch.testing.assert_close(sharded["abs_pos"], whole["abs_pos"])
    return n


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("jcfg", [LLAMA, G2], ids=["linear", "mixed"])
def test_sharded_cache_steps_equal_the_one_device_steps(jcfg, quant):
    cfg, params = _port(jcfg, jax_init_params(jcfg, jax.random.PRNGKey(5)))
    mesh = make_mesh(MeshConfig(tensor=N))
    one, two = LlamaModel(cfg, "cpu"), LlamaModel(cfg, "cpu", mesh)
    tp_params = shard_params(cfg, copy.deepcopy(params), mesh)
    assert two.cache_head_shards == N and one.cache_head_shards == 1

    def caches(model):
        if cfg.sliding_window_pattern > 1:
            return model.init_mixed_cache(2, 64, 128, quantize=quant)
        return model.init_cache(2, 64, quantize=quant)

    whole, sharded = caches(one), caches(two)
    for name in SECTIONS:
        if name in whole:
            w, s = whole[name].shape, sharded[name].shape
            assert s == (N * w[0],) + w[1:3] + (w[3] // N,) + w[4:], name
    assert two.cache_shards(sharded) == N and one.cache_shards(whole) == 1
    rng = np.random.default_rng(52)
    toks = torch.tensor(rng.integers(1, 128, (2, 12)), dtype=torch.int32)
    la, whole = one.prefill(params, toks, whole)
    lb, sharded = two.prefill(tp_params, toks, sharded)
    # an int8 cache: one rounding tie of _kv_quant flipped by the shards'
    # f32 reduction order moves the logits ~1e-4 (as the JAX contiguous
    # int8 steps against the port's, tests/test_torch_interleave.py)
    tol = 1e-3 if quant else 1e-5
    torch.testing.assert_close(lb, la, atol=tol, rtol=tol)
    # the control: shard 1 reads shard 0's kv heads
    control = {k: v.clone() for k, v in sharded.items()}
    for name in SECTIONS:
        if name in control:
            sh = _shards(control, name)
            sh[1].copy_(sh[0])
    step = torch.tensor(rng.integers(1, 128, (2, 3)), dtype=torch.int32)
    la, whole = one.verify_step(params, step, whole)
    lb, sharded = two.verify_step(tp_params, step, sharded)
    lc, _ = two.verify_step(tp_params, step, control)
    torch.testing.assert_close(lb, la, atol=tol, rtol=tol)
    assert (lc - la).abs().max() > 1e-2
    assert _assert_heads(sharded, whole, quant) >= 2


def _jax_tokens(jcfg, jparams, sc):
    eng = JaxServingEngine(jcfg, jparams, JaxServingConfig(**sc)).start()
    try:
        eng.register_prefix(PREFIX)
        return [eng.submit(p).result(timeout=TIMEOUT)["tokens"]
                for p in _traffic()]
    finally:
        eng.stop()


def _port_burst(cfg, params, sc, mesh=None):
    """The traffic as one burst (all submitted before the engine starts,
    so request i lands in slot i on both engines); returns (tokens, the
    batch cache, the snapshot)."""
    eng = ServingEngine(cfg, params, ServingConfig(**sc), device="cpu",
                        mesh=mesh)
    eng.register_prefix(PREFIX)
    futs = [eng.submit(p) for p in _traffic()]
    eng.start()
    try:
        toks = [f.result(timeout=TIMEOUT)["tokens"] for f in futs]
        snap = eng.debug_snapshot()
        assert eng.active_slots == 0 and eng.counters["engine_errors"] == 0
    finally:
        eng.stop()
    return toks, eng._cache, snap


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_mesh_tokens_match_tensor_1_and_the_jax_engine(case):
    jcfg, extra, layout = CASES[case]
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    sc = dict(SC, **extra)
    want = _jax_tokens(jcfg, jparams, sc)
    cfg, params = _port(jcfg, jparams)
    one, whole, snap1 = _port_burst(cfg, params, sc)
    two, sharded, snap2 = _port_burst(
        cfg, params, sc, make_mesh(MeshConfig(tensor=N)))
    assert one == want == two
    assert (snap2["paged_decode"], snap2["cache_layout"],
            snap2["tensor_parallel"], snap2["cache_head_shards"],
            snap2["paged_tp_shards"]) == (False, layout, N, N, 0)
    assert snap1["cache_head_shards"] == 1
    if "speculate_k" in extra:
        assert snap2["counters"]["spec_accepted"] > 0
        assert snap2["counters"]["spec_proposed"] == \
            snap1["counters"]["spec_proposed"]
    assert _assert_heads(sharded, whole,
                         extra.get("quantize_kv_int8", False)) >= 2
