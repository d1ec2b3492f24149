"""Multi-LoRA serving on the port, against the JAX package, on the CPU
(f32 tiny models, seeded numpy weights and adapters):

- ``_ml_delta`` against the JAX one over mixed adapter ids, 0 included
  (1e-5 at unit-normal inputs, whose deltas reach ~20);
- the paged steps (``paged_prefill_chunk_step``, ``paged_decode_step``,
  ``paged_verify_step`` with an n_tokens mix) and the contiguous ones
  (``prefill``, ``prefill_chunk_step``, ``verify_step``) with all seven
  targets against the JAX steps (``use_pallas=False``), over a plain and
  an int8 arena or cache: logits within 1e-4, arenas within 1e-5 (int8:
  the integers within one step, the scales within 1e-5);
- refusals: MLA steps with adapters, an MoE model's MLP targets.

The engine's cases are in ``test_torch_multi_lora_engine.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu_torch.models import (LlamaModel, init_params,
                                                 tiny_mla, tiny_moe)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.llama import _ml_delta

TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
DIMS = dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=256)
JCFG = jllama.tiny_llama(**DIMS, dtype=jnp.float32, param_dtype=jnp.float32)
T, N_PAGES, COLS = 8, 24, 8
N_SLOTS, RANK = 4, 4          # adapter slots (0 = base) and rank
IDS = np.array([2, 0, 3], np.int32)    # one adapter slot per row


def target_dims(cfg) -> dict:
    e, hd, m = cfg.embed_dim, cfg.head_dim_, cfg.mlp_dim
    return {"wq": (e, cfg.n_heads * hd), "wk": (e, cfg.n_kv_heads * hd),
            "wv": (e, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, e),
            "w_gate": (e, m), "w_up": (e, m), "w_down": (m, e)}


def numpy_stacks(cfg, seed: int, targets=TARGETS, n=N_SLOTS,
                 rank=RANK) -> dict:
    """Adapter stacks {t: {"a": (L, n, in, r), "b": (L, n, r, out),
    "scale": (L, n)}}, slot 0 zero (the base), B non-zero elsewhere."""
    rng = np.random.default_rng(seed)
    dims = target_dims(cfg)
    out = {}
    for t in targets:
        din, dout = dims[t]
        a = 0.2 * rng.normal(size=(cfg.n_layers, n, din, rank))
        b = 0.2 * rng.normal(size=(cfg.n_layers, n, rank, dout))
        a[:, 0] = b[:, 0] = 0.0
        scale = np.tile(np.linspace(0.0, 1.5, n), (cfg.n_layers, 1))
        out[t] = {"a": a.astype(np.float32), "b": b.astype(np.float32),
                  "scale": scale.astype(np.float32)}
    return out


def as_torch(stacks) -> dict:
    return {t: {k: torch.from_numpy(v.copy()) for k, v in ad.items()}
            for t, ad in stacks.items()}


def as_jax(stacks) -> dict:
    return jax.tree_util.tree_map(jnp.asarray, stacks)


@pytest.fixture(scope="module")
def tree():
    """Seeded numpy weights in the JAX layout (norms near 1)."""
    rng = np.random.default_rng(20261017)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(JCFG, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.fixture(scope="module")
def pair(tree):
    cfg = config_from_jax(JCFG, torch.float32)
    return (jllama.LlamaModel(JCFG),
            jax.tree_util.tree_map(jnp.asarray, tree),
            LlamaModel(cfg, device="cpu"),
            params_from_jax(tree, cfg, device="cpu"))


def test_ml_delta_matches_jax_with_mixed_ids():
    rng = np.random.default_rng(1)
    ad = {"a": rng.normal(size=(4, 24, 4)).astype(np.float32),
          "b": rng.normal(size=(4, 4, 40)).astype(np.float32),
          "scale": np.array([0.0, 2.0, 0.5, 1.0], np.float32)}
    ad["a"][0] = ad["b"][0] = 0.0
    x = rng.normal(size=(5, 3, 24)).astype(np.float32)
    ids = np.array([0, 2, 1, 3, 0], np.int32)
    want = np.asarray(jllama._ml_delta(jnp.asarray(x), as_jax(ad),
                                       jnp.asarray(ids)))
    got = _ml_delta(torch.from_numpy(x), as_torch({"t": ad})["t"],
                    torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[0].any() and not got[4].any()     # slot 0: the base
    assert np.abs(got[1]).max() > 0.1


def _prompts():
    rng = np.random.default_rng(8)
    return [[int(t) for t in rng.integers(1, 128, n)] for n in (21, 17, 19)]


def _assert_arena_close(jarena, arena, quant: bool):
    """Every section of a JAX arena or cache against the port's (the
    port's arena has one more page, its sink)."""
    for name, j in jarena.items():
        j = np.asarray(j)
        got = arena[name].numpy()
        if got.ndim > 1:
            got = got[:, :j.shape[1]]
        if quant and got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - j.astype(np.int32)).max() \
                <= 1, name
        else:
            np.testing.assert_allclose(got, j, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "kv_int8"])
def test_paged_steps_with_adapters_match_jax(pair, quant):
    """Two prefill chunks of three prompts (ids 2, 0, 3), three greedy
    decode steps, then a K = 3 verify step with n_tokens (3, 1, 2)."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    stacks = numpy_stacks(cfg, seed=11)
    jad, tad = as_jax(stacks), as_torch(stacks)
    jids, tids = jnp.asarray(IDS), torch.from_numpy(IDS)
    b = len(IDS)
    table = np.random.default_rng(5).permutation(N_PAGES)[:b * COLS] \
        .reshape(b, COLS).astype(np.int32)
    jarena = jmodel.init_paged_arena(N_PAGES, T, quantize=quant)
    arena = model.init_paged_arena(N_PAGES, T, quantize=quant)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jlen = jnp.zeros((b,), jnp.int32)
    tlen = torch.zeros((b,), dtype=torch.int32)
    prompts = _prompts()
    chunk = 11
    for start in (0, chunk):
        toks = np.zeros((b, chunk), np.int32)
        true = np.zeros((b,), np.int32)
        for i, p in enumerate(prompts):
            part = p[start:start + chunk]
            toks[i, :len(part)] = part
            true[i] = len(part)
        lj, jarena, jlen = jmodel.paged_prefill_chunk_step(
            jparams, jnp.asarray(toks), jarena, jt, jlen, jnp.asarray(true),
            jad, jids, use_pallas=False)
        lt, arena, tlen = model.paged_prefill_chunk_step(
            params, torch.from_numpy(toks), arena, tt, tlen,
            torch.from_numpy(true), adapters=tad, adapter_ids=tids)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
    tok = np.asarray(jnp.argmax(lj, -1), np.int32)
    for _ in range(3):
        lj, jarena, jlen = jmodel.paged_decode_step(
            jparams, jnp.asarray(tok), jarena, jt, jlen, None, jad, jids,
            use_pallas=False)
        lt, arena, tlen = model.paged_decode_step(
            params, torch.tensor(tok), arena, tt, tlen,
            adapters=tad, adapter_ids=tids)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                                   atol=1e-4)
        assert np.array_equal(tlen.numpy(), np.asarray(jlen))
        tok = np.asarray(jnp.argmax(lj, -1), np.int32)
    drafts = np.random.default_rng(3).integers(1, 128, (b, 3)) \
        .astype(np.int32)
    n_tok = np.array([3, 1, 2], np.int32)
    lj, jarena = jmodel.paged_verify_step(
        jparams, jnp.asarray(drafts), jarena, jt, jlen, None, jad, jids,
        jnp.asarray(n_tok), use_pallas=False)
    lt, arena = model.paged_verify_step(
        params, torch.from_numpy(drafts), arena, tt, tlen,
        n_tokens=torch.from_numpy(n_tok), adapters=tad, adapter_ids=tids)
    for i, n in enumerate(n_tok):     # rows past n_tokens: never read
        np.testing.assert_allclose(lt[i, :n].numpy(), np.asarray(lj)[i, :n],
                                   rtol=1e-4, atol=1e-4)
    _assert_arena_close(jarena, arena, quant)
    # the adapters bite: the base step's logits differ
    base, _ = model.paged_verify_step(
        params, torch.from_numpy(drafts), arena, tt, tlen,
        n_tokens=torch.from_numpy(n_tok))
    assert (base[0, 0] - lt[0, 0]).abs().max() > 1e-2
    assert torch.allclose(base[1, 0], lt[1, 0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "kv_int8"])
def test_contiguous_steps_with_adapters_match_jax(pair, quant):
    """``prefill`` (padded, true lengths), one ``prefill_chunk_step``, then
    a K = 2 ``verify_step`` with an inactive row, ids (2, 0, 3)."""
    jmodel, jparams, model, params = pair
    stacks = numpy_stacks(model.cfg, seed=12)
    jad, tad = as_jax(stacks), as_torch(stacks)
    jids, tids = jnp.asarray(IDS), torch.from_numpy(IDS)
    b = len(IDS)
    prompts = _prompts()
    head = np.zeros((b, 16), np.int32)
    true = np.array([16, 12, 14], np.int32)
    for i, p in enumerate(prompts):
        head[i, :true[i]] = p[:true[i]]
    jcache = jmodel.init_cache(b, 64, quantize=quant)
    cache = model.init_cache(b, 64, quantize=quant)
    lj, jcache = jmodel.prefill(jparams, jnp.asarray(head), jcache,
                               jnp.asarray(true), jad, jids)
    lt, cache = model.prefill(params, torch.from_numpy(head), cache,
                              torch.from_numpy(true), tad, tids)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    rest = np.zeros((b, 5), np.int32)
    rtrue = np.array([5, 3, 4], np.int32)
    for i, p in enumerate(prompts):
        part = p[true[i]:true[i] + rtrue[i]]
        rest[i, :len(part)] = part
    lj, jcache = jmodel.prefill_chunk_step(jparams, jnp.asarray(rest),
                                           jcache, jnp.asarray(rtrue), jad,
                                           jids)
    lt, cache = model.prefill_chunk_step(params, torch.from_numpy(rest),
                                         cache, torch.from_numpy(rtrue),
                                         tad, tids)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    drafts = np.random.default_rng(4).integers(1, 128, (b, 2)) \
        .astype(np.int32)
    active = np.array([True, False, True])
    lj, jcache = jmodel.verify_step(jparams, jnp.asarray(drafts), jcache,
                                    jnp.asarray(active), jad, jids)
    lt, cache = model.verify_step(params, torch.from_numpy(drafts), cache,
                                  torch.from_numpy(active), tad, tids)
    np.testing.assert_allclose(lt[active].numpy(),
                               np.asarray(lj)[active], rtol=1e-4, atol=1e-4)
    _assert_arena_close(jcache, cache, quant)


def test_adapters_are_refused_where_the_jax_model_refuses_them():
    cfg = tiny_mla(vocab_size=64, embed_dim=64, n_layers=1,
                   dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = LlamaModel(cfg, device="cpu")
    arena = model.init_paged_arena(4, 8)
    ad = {"wq": {"a": torch.zeros(1, 2, 64, 2),
                 "b": torch.zeros(1, 2, 2, 64), "scale": torch.zeros(1, 2)}}
    one = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not target MLA"):
        model.paged_decode_step(params, one, arena,
                                torch.zeros((1, 2), dtype=torch.int32),
                                one, adapters=ad, adapter_ids=one)
    with pytest.raises(ValueError, match="do not target MLA"):
        model.prefill(params, one[None], model.init_cache(1, 8),
                      adapters=ad, adapter_ids=one)
    mcfg = tiny_moe(vocab_size=64, embed_dim=32, n_layers=1, mlp_dim=64,
                    dtype=torch.float32)
    mmodel = LlamaModel(mcfg, device="cpu")
    mparams = init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="no dense mlp weights"):
        mmodel.prefill(mparams, one[None], mmodel.init_cache(1, 8),
                       adapters={"w_up": ad["wq"]}, adapter_ids=one)
    with pytest.raises(ValueError, match="adapter_ids"):
        mmodel.prefill(mparams, one[None], mmodel.init_cache(1, 8),
                       adapters={"wq": ad["wq"]})
