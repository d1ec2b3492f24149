"""Gemma 2 and Gemma 3's branches on the port's model, against the JAX
package on the same seeded numpy weights (every norm, the sandwich norms
included, drawn away from identity):

- ``forward`` with the local/global window interleave, both RoPE tables
  (Gemma 3's local base), both soft caps, the query scalar and the
  sandwich norms: f32 logits within 1e-5, bf16 within 3e-2;
- ``prefill`` then ``decode_step`` on linear, ring and mixed caches, f32
  and int8, decoding past the ring's wraparound: every step's logits
  within 1e-5 (int8: 1e-3, since f32 noise of 1e-7 at a rounding tie of
  ``_kv_quant`` flips a stored int8 by one step now and then, which moved
  a logit by 2.1e-4 here) and the caches' sections equal (int8 ones but
  for such a flip);
- ``verify_step`` at K = 4 on a ring and a mixed cache with the drafts
  partly rejected: the rejected rows stay invisible to the steps after;
- ``insert_into_slot`` against the JAX one, in place;
- the paged steps of a pattern-1 config carrying soft caps, the query
  scalar and sandwich norms (and Gemma 3's local base) against the JAX
  ``forward``, f32 within 1e-5, and over an int8 arena against the JAX
  contiguous int8 steps within 1e-3;
- the refusals: the paged steps of an interleave, the caches' shape
  checks, MLA with a soft cap, a pattern that does not divide the
  layers; training these configs builds a trainer, a process-group mesh
  refused; and the HF names of the sandwich norms.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models.convert import (expected_keys,
                                                         from_hf_state_dict,
                                                         to_hf_state_dict)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.llama import tiny_llama, tiny_mla
from k8s_runpod_kubelet_tpu_torch.models.quant import quantize_params
from k8s_runpod_kubelet_tpu_torch.parallel.sharding import param_logical_axes

BASE = dict(vocab_size=128, embed_dim=64, n_heads=4, n_kv_heads=2,
            head_dim=32, mlp_dim=128, max_seq_len=256)
# the JAX tests' Gemma-2-shaped config (tests/test_mixed_cache.py): window
# 8 on even layers, soft caps, the query scalar, sandwich norms
G2 = dict(n_layers=4, sliding_window=8, sliding_window_pattern=2,
          attn_logit_softcap=50.0, query_pre_attn_scalar=64.0,
          post_norms=True, logit_softcap=30.0)
# Gemma-3-shaped: two local layers to one global, a local RoPE base beside
# a scaled global one, the q/k norm, zero-centered norms
G3 = dict(n_layers=6, sliding_window=8, sliding_window_pattern=3,
          rope_theta=1_000_000.0, rope_local_theta=10_000.0,
          rope_scaling={"rope_type": "linear", "factor": 8.0},
          query_pre_attn_scalar=48.0, post_norms=True, qk_norm=True,
          norm_zero_centered=True, embed_scale=True, tie_embeddings=True,
          mlp_activation="gelu_tanh", norm_eps=1e-6)
# the JAX tests' uniform window (tests/test_ring_cache.py)
WINDOW = dict(n_layers=2, sliding_window=8)
CONFIGS = {"g2": G2, "g3": G3, "window": WINDOW}
RING = 16


def _jax_cfg(name, dtype=jnp.float32, **kw):
    return jllama.tiny_llama(**{**BASE, **CONFIGS[name], **kw},
                             name=f"tiny-{name}", dtype=dtype,
                             param_dtype=jnp.float32)


def _numpy_tree(jcfg, seed: int):
    """Seeded weights in the JAX layout: matmuls 0.05 N(0,1), norms 1 +
    0.1 N(0,1) (0.1 N(0,1) when zero-centered), away from identity."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    centre = 0.0 if jcfg.norm_zero_centered else 1.0

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (centre + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.fixture(autouse=True)
def _bounded_xla_state():
    """Each test starts with jax's compilation caches cleared: the eager
    JAX steps here compile hundreds of small executables, and the XLA CPU
    compiler segfaults deep into such a run (``tests/conftest.py``, which
    clears them between modules)."""
    jax.clear_caches()


@pytest.fixture(scope="module")
def trees():
    return {name: _numpy_tree(_jax_cfg(name), 20261019 + i)
            for i, name in enumerate(CONFIGS)}


def _pair(name, tree, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    jcfg = _jax_cfg(name, jdtype, **kw)
    cfg = config_from_jax(jcfg, tdtype)
    return (jllama.LlamaModel(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
            LlamaModel(cfg, device="cpu"),
            params_from_jax(tree, cfg, device="cpu"))


def _tokens(n, b=2, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (b, n)).astype(
        np.int32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# -- forward --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["g2", "g3"])
def test_forward_matches_the_jax_model(name, trees):
    jmodel, jp, model, params = _pair(name, trees[name])
    toks = _tokens(40)
    want = jmodel.forward(jp, jnp.asarray(toks))
    got = model.forward(params, torch.from_numpy(toks), train=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["g2", "g3"])
def test_forward_bf16_matches_the_jax_model(name, trees):
    jmodel, jp, model, params = _pair(name, trees[name], jnp.bfloat16,
                                      torch.bfloat16)
    toks = _tokens(24)
    want = jmodel.forward(jp, jnp.asarray(toks))
    got = model.forward(params, torch.from_numpy(toks), train=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=0)


def test_each_branch_moves_the_logits(trees):
    """Each Gemma field left out changes the forward by far more than the
    tolerance, so the parity above holds each one."""
    _, _, model, params = _pair("g3", trees["g3"])
    toks = torch.from_numpy(_tokens(40))
    ref = model.forward(params, toks, train=False)
    for field, off in (("sliding_window_pattern", 1),
                       ("rope_local_theta", None),
                       ("query_pre_attn_scalar", None),
                       ("post_norms", False)):
        cfg = dataclasses.replace(model.cfg, **{field: off})
        tree = params
        if field == "post_norms":
            tree = dict(params, layers={k: v for k, v in
                                        params["layers"].items()
                                        if "post" not in k})
        got = LlamaModel(cfg, device="cpu").forward(tree, toks, train=False)
        assert (got - ref).abs().max() > 1e-2, field
    _, _, m2, p2 = _pair("g2", trees["g2"])
    ref2 = m2.forward(p2, toks, train=False)
    for field in ("attn_logit_softcap", "logit_softcap"):
        cfg = dataclasses.replace(m2.cfg, **{field: 0.5})
        got = LlamaModel(cfg, device="cpu").forward(p2, toks, train=False)
        assert (got - ref2).abs().max() > 1e-2, field


def test_logit_softcap_rounds_in_the_compute_dtype(trees):
    """The final soft cap runs on bf16 logits before the f32 cast, as the
    JAX ``_head_logits`` does: the port's last-token logits equal the
    bf16 cap of its own uncapped bf16 logits exactly."""
    _, _, model, params = _pair("g2", trees["g2"], jnp.bfloat16,
                                torch.bfloat16)
    toks = torch.from_numpy(_tokens(12))
    cache = model.init_cache(2, 32)
    got, _ = model.prefill(params, toks, cache)
    raw = dataclasses.replace(model.cfg, logit_softcap=None)
    plain, _ = LlamaModel(raw, device="cpu").prefill(
        params, toks, model.init_cache(2, 32))
    want = (torch.tanh(plain.to(torch.bfloat16) / 30.0) * 30.0).float()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- contiguous caches ------------------------------------------------------------

def _caches(name, jmodel, model, layout, quant):
    if layout == "linear":
        return (jmodel.init_cache(2, 64, quantize=quant),
                model.init_cache(2, 64, quantize=quant))
    if layout == "ring":
        return (jmodel.init_ring_cache(2, RING, quantize=quant),
                model.init_ring_cache(2, RING, quantize=quant))
    return (jmodel.init_mixed_cache(2, 64, RING, quantize=quant),
            model.init_mixed_cache(2, 64, RING, quantize=quant))


def _same_cache(jcache, cache):
    """Every section equal: f32 ones within 1e-5, int8 ones exactly but
    for a rare step of 1, where f32 noise of 1e-7 met a rounding tie in
    ``_kv_quant`` (the logits stay within 1e-5 through it)."""
    assert set(jcache) == set(cache)
    for k, v in jcache.items():
        got, want = _np(cache[k]), _np(v)
        if cache[k].dtype == torch.int8:
            off = np.abs(got - want)
            assert off.max() <= 1 and (off > 0).mean() < 1e-3, k
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=k)


CASES = [("g2", "mixed"), ("g3", "mixed"), ("g2", "linear"),
         ("window", "ring"), ("window", "linear")]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name,layout", CASES)
def test_prefill_and_decode_past_the_wraparound(name, layout, quant, trees):
    """Prefill 6 tokens, then decode to position 40: 2.5 times round a
    16-slot ring; every step's logits and the whole cache against the
    JAX model's."""
    jmodel, jp, model, params = _pair(name, trees[name])
    toks = _tokens(40)
    atol = 1e-3 if quant else 1e-5
    jcache, cache = _caches(name, jmodel, model, layout, quant)
    jl, jcache = jmodel.prefill(jp, jnp.asarray(toks[:, :6]), jcache)
    tl, cache = model.prefill(params, torch.from_numpy(toks[:, :6]), cache)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0)
    _same_cache(jcache, cache)
    for t in range(6, 40):
        jl, jcache = jmodel.decode_step(jp, jnp.asarray(toks[:, t]), jcache)
        tl, cache = model.decode_step(params, torch.from_numpy(toks[:, t]),
                                      cache)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=atol, rtol=0,
                                   err_msg=f"position {t}")
    _same_cache(jcache, cache)


@pytest.mark.parametrize("name,layout", [("g2", "mixed"), ("window", "ring"),
                                         ("g3", "mixed")])
def test_rejected_verify_rows_stay_invisible(name, layout, trees):
    """A 4-wide verify whose last rows are rejected (the index advances by
    2 only; row 1 inactive) then decoding on: the JAX model's logits
    throughout, so the stale rows' K/V in the ring is never read."""
    jmodel, jp, model, params = _pair(name, trees[name])
    toks = _tokens(40, seed=3)
    jcache, cache = _caches(name, jmodel, model, layout, False)
    _, jcache = jmodel.prefill(jp, jnp.asarray(toks[:, :10]), jcache)
    _, cache = model.prefill(params, torch.from_numpy(toks[:, :10]), cache)
    active = np.array([True, False])
    for start in (10, 12, 14, 16):
        drafts = toks[:, start:start + 4]
        jl, jcache = jmodel.verify_step(jp, jnp.asarray(drafts), jcache,
                                        jnp.asarray(active))
        tl, cache = model.verify_step(params, torch.from_numpy(drafts),
                                      cache, torch.from_numpy(active))
        np.testing.assert_allclose(_np(tl)[0], _np(jl)[0], atol=1e-5,
                                   rtol=0)
        jcache = dict(jcache, index=jcache["index"] + jnp.asarray([2, 0]))
        cache["index"] += torch.tensor([2, 0], dtype=torch.int32)
    _same_cache(jcache, cache)
    for t in range(18, 30):
        jl, jcache = jmodel.decode_step(jp, jnp.asarray(toks[:, t]), jcache)
        tl, cache = model.decode_step(params, torch.from_numpy(toks[:, t]),
                                      cache)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", ["mixed", "linear"])
def test_insert_into_slot_in_place(layout, trees):
    jmodel, jp, model, params = _pair("g2", trees["g2"])
    toks = _tokens(9, b=1, seed=4)
    jbatch, batch = _caches("g2", jmodel, model, layout, True)
    _, jbatch = jmodel.prefill(jp, jnp.asarray(_tokens(5)), jbatch)
    _, batch = model.prefill(params, torch.from_numpy(_tokens(5)), batch)
    jsingle, single = (c(1, 64, RING, quantize=True) if layout == "mixed"
                       else c(1, 64, quantize=True) for c in (
                           jmodel.init_mixed_cache if layout == "mixed"
                           else jmodel.init_cache,
                           model.init_mixed_cache if layout == "mixed"
                           else model.init_cache))
    _, jsingle = jmodel.prefill(jp, jnp.asarray(toks), jsingle)
    _, single = model.prefill(params, torch.from_numpy(toks), single)
    before = {k: v.clone() for k, v in single.items()}
    jbatch = jllama.LlamaModel.insert_into_slot(jbatch, jsingle, 1)
    ptrs = {k: v.data_ptr() for k, v in batch.items()}
    out = LlamaModel.insert_into_slot(batch, single, 1)
    assert out is batch and {k: v.data_ptr() for k, v in batch.items()} == ptrs
    _same_cache(jbatch, batch)
    for k, v in before.items():
        torch.testing.assert_close(single[k], v, rtol=0, atol=0)


def test_verify_step_bounds_check_stays_eager(trees):
    """Past a linear section the eager step raises; with ``check`` off (the
    captured decode step) the write past the end is dropped, as the JAX
    scatter drops it."""
    _, _, model, params = _pair("g2", trees["g2"])
    cache = model.init_mixed_cache(1, 16, RING)
    cache["index"].fill_(15)
    with pytest.raises(ValueError, match="past the cache length"):
        model.verify_step(params, torch.zeros((1, 2), dtype=torch.int32),
                          cache)
    before = cache["k_g"].clone()
    model.verify_step(params, torch.zeros((1, 2), dtype=torch.int32), cache,
                      check=False)
    assert (cache["k_g"][:, 0, :15] == before[:, 0, :15]).all()
    assert not (cache["k_g"][:, 0, 15] == before[:, 0, 15]).all()


# -- paged steps of a pattern-1 config with Gemma's branches ------------------------

T, N_PAGES, COLS = 8, 40, 12


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-layout", "int8"])
def test_paged_steps_carry_soft_caps_and_sandwich_norms(quant, trees):
    """A uniform window (pattern 1) carrying both soft caps, the query
    scalar, sandwich norms and a local RoPE base pages: chunked paged
    prefill and 20 greedy decode steps past the window. Over a bf16-layout
    arena each step's logits are within 1e-5 of the JAX model's
    ``forward`` over the same tokens at that position. Over an int8 arena
    they are within 1e-3 (the int8 tolerance above) of the JAX model's
    contiguous int8 steps (``prefill_chunk_step``, ``decode_step``) on the
    same chunks and tokens, which take the same per-row KV scales; the
    port's own contiguous int8 steps give the same logits too. (The JAX
    paged steps at this config crash the XLA CPU runtime now and then, so
    the JAX side is its contiguous path.)"""
    extra = dict(attn_logit_softcap=50.0, logit_softcap=30.0,
                 query_pre_attn_scalar=48.0, post_norms=True,
                 rope_local_theta=10_000.0, sliding_window=16)
    tree = _numpy_tree(_jax_cfg("window", **extra), 7)
    jmodel, jp, model, params = _pair("window", tree, **extra)
    table = np.random.default_rng(5).permutation(N_PAGES)[:2 * COLS]
    table = torch.from_numpy(table.reshape(2, COLS).astype(np.int32))
    arena = model.init_paged_arena(N_PAGES, T, quantize=quant)
    lengths = torch.zeros((2,), dtype=torch.int32)
    seq = _tokens(24, seed=6)
    got = []
    for start in range(0, 24, 8):
        tl, arena, lengths = model.paged_prefill_chunk_step(
            params, torch.from_numpy(seq[:, start:start + 8].copy()), arena,
            table, lengths, torch.full((2,), 8, dtype=torch.int32))
    got.append(tl)
    for _ in range(20):
        tok = got[-1].argmax(-1).to(torch.int32)
        seq = np.concatenate([seq, tok.numpy()[:, None]], axis=1)
        tl, arena, lengths = model.paged_decode_step(params, tok, arena,
                                                     table, lengths)
        got.append(tl)
    if quant:
        eight = jnp.full((2,), 8, dtype=jnp.int32)
        jcache = jmodel.init_cache(2, 64, quantize=True)
        cache = model.init_cache(2, 64, quantize=True)
        want, mine = [], []
        for start in range(0, 24, 8):
            chunk = seq[:, start:start + 8].copy()
            jl, jcache = jmodel.prefill_chunk_step(jp, jnp.asarray(chunk),
                                                   jcache, eight)
            tl, cache = model.prefill_chunk_step(
                params, torch.from_numpy(chunk), cache,
                torch.full((2,), 8, dtype=torch.int32))
        want.append(_np(jl))
        mine.append(_np(tl))
        for t in range(24, seq.shape[1]):
            jl, jcache = jmodel.decode_step(jp, jnp.asarray(seq[:, t]),
                                            jcache)
            tl, cache = model.decode_step(
                params, torch.from_numpy(seq[:, t].copy()), cache)
            want.append(_np(jl))
            mine.append(_np(tl))
        want = np.stack(want, 1)
        np.testing.assert_allclose(np.stack(mine, 1), want, atol=1e-3,
                                   rtol=0)
        atol = 1e-3
    else:
        want = np.asarray(jmodel.forward(jp, jnp.asarray(seq)),
                          np.float32)[:, 23:]
        atol = 1e-5
    for i, tl in enumerate(got):
        np.testing.assert_allclose(_np(tl), want[:, i], atol=atol, rtol=0,
                                   err_msg=f"position {23 + i}")


# -- refusals and plumbing --------------------------------------------------------------

def test_the_interleave_refuses_the_paged_steps(trees):
    _, _, model, params = _pair("g2", trees["g2"])
    arena = model.init_paged_arena(8, 4)     # a prefix pool may hold pages
    with pytest.raises(ValueError, match="cannot page"):
        model.paged_decode_step(params, torch.zeros(1, dtype=torch.int32),
                                arena, torch.zeros((1, 2), dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32))


def test_cache_shapes_and_their_checks(trees):
    _, _, model, _ = _pair("g2", trees["g2"])
    c = model.init_mixed_cache(2, 64, RING, quantize=True)
    assert c["k_l"].shape == (2, 2, RING, 2, 32)      # 2 local layers
    assert c["k_g"].shape == (2, 2, 64, 2, 32)        # 2 global layers
    assert c["k_l_scale"].shape == (2, 2, RING, 2)
    assert c["abs_pos"].shape == (2, RING) and (c["abs_pos"] == -1).all()
    with pytest.raises(ValueError, match="exceed the window"):
        model.init_mixed_cache(1, 64, 8)
    with pytest.raises(ValueError, match="uniform sliding_window"):
        model.init_ring_cache(1, 64)
    _, _, wmodel, _ = _pair("window", trees["window"])
    with pytest.raises(ValueError, match="interleave"):
        wmodel.init_mixed_cache(1, 64, RING)
    with pytest.raises(ValueError, match="exceed the window"):
        wmodel.init_ring_cache(1, 8)
    with pytest.raises(ValueError, match="exceeds cache sections"):
        model.prefill(_pair("g2", trees["g2"])[3],
                      torch.zeros((1, RING + 1), dtype=torch.int32),
                      model.init_mixed_cache(1, 64, RING))


def test_config_checks():
    with pytest.raises(ValueError, match="MLA does not compose"):
        LlamaModel(tiny_mla(attn_logit_softcap=50.0), device="cpu")
    with pytest.raises(ValueError, match="MLA does not compose"):
        LlamaModel(tiny_mla(query_pre_attn_scalar=64.0), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        LlamaModel(tiny_llama(n_layers=4, sliding_window=8,
                              sliding_window_pattern=3), device="cpu")
    g3 = config_from_jax(jllama.gemma3_12b(), torch.bfloat16)
    assert g3.layer_windows() == (1024,) * 5 + (None,)
    assert g3.sm_scale == 256 ** -0.5


def test_training_refuses_gemma2_and_3():
    """Gemma 2 and 3 configs build a ``Trainer`` (their training is
    ported, ``tests/test_torch_gemma_train.py``); what the trainer still
    refuses by name on them is a mesh over a process group."""
    from types import SimpleNamespace

    from k8s_runpod_kubelet_tpu_torch.workloads.train import (TrainConfig,
                                                              Trainer)
    tc = TrainConfig(batch_size=2, seq_len=16)
    for name in ("g2", "g3"):
        cfg = config_from_jax(_jax_cfg(name), torch.float32)
        tr = Trainer(cfg, tc, device="cpu")
        assert tr.params["layers"]["attn_post_norm"].shape[0] == cfg.n_layers
    # a seq-2 mesh as rank 0 of a process group sees it
    group = SimpleNamespace(seq=2, tensor=1, rank=0, in_process=False)
    with pytest.raises(ValueError, match="over a process group is not "
                       "ported"):
        Trainer(cfg, tc, device="cpu", mesh=group)


def test_post_norms_stay_f32_unquantized_and_replicated(trees):
    _, _, model, params = _pair("g2", trees["g2"], tdtype=torch.bfloat16)
    q = quantize_params(model.cfg, params, bits=4)
    for name in ("attn_post_norm", "mlp_post_norm"):
        assert q["layers"][name].dtype == torch.float32
        assert param_logical_axes(model.cfg)["layers"][name] == (
            "layer", "norm")
    assert q["lm_head"]["q4"].dtype == torch.uint8
    # a tied head stays the bf16 embedding's product
    _, _, m3, p3 = _pair("g3", trees["g3"], tdtype=torch.bfloat16)
    q3 = quantize_params(m3.cfg, p3, bits=4)
    assert "lm_head" not in q3 and q3["tok_embed"].dtype == torch.bfloat16


def test_hf_names_of_the_sandwich_norms(trees):
    """Gemma 2's HF layout: post_attention_layernorm is the attention
    output's norm, pre_feedforward_layernorm the MLP's input norm; a
    round trip keeps every leaf."""
    _, _, model, params = _pair("g2", trees["g2"])
    cfg = model.cfg
    keys = expected_keys(cfg)
    for name in ("post_attention_layernorm", "pre_feedforward_layernorm",
                 "post_feedforward_layernorm", "input_layernorm"):
        assert f"layers.0.{name}.weight" in keys
    sd = to_hf_state_dict(cfg, params)
    torch.testing.assert_close(
        sd["model.layers.1.post_attention_layernorm.weight"],
        params["layers"]["attn_post_norm"][1])
    back = from_hf_state_dict(cfg, sd, device="cpu")
    for k, v in params["layers"].items():
        torch.testing.assert_close(back["layers"][k], v, rtol=0, atol=0)
