"""The port's Llama paged steps against the JAX package's ``LlamaModel``.

Both packages get the same parameters (numpy, from a seed; the port's
through ``params_from_jax``) and the same token ids and page tables:

- f32 (``tiny_llama(dtype=float32)``): ``paged_prefill_chunk_step`` and
  ``paged_decode_step`` logits within atol 1e-4 (f32 matmuls and softmax
  summed in other orders over two layers), the arena pages they write
  within 1e-5, and a 16-token greedy loop token-identical;
- bf16: logits within atol 3e-2 (the frameworks round bf16 at other
  places; near-ties may then pick other tokens, which is why bf16 is held
  to a logit tolerance and not to tokens);
- the drop-write contract: an inactive slot's stale table row, and rows
  past a prefill chunk's true length, write nothing but the sink page.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu_torch.models import (MODEL_CONFIGS, LlamaModel,
                                                 init_params, llama3_8b,
                                                 llama31_8b, tiny_llama)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)

DIMS = dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=256)
T = 8          # page tokens
N_PAGES = 24
COLS = 8       # table width: 64 positions a slot


def _jax_cfg(dtype):
    return jllama.tiny_llama(**DIMS, dtype=dtype, param_dtype=jnp.float32)


def _numpy_tree(seed: int):
    """Seeded numpy parameters in the JAX tree layout (norm weights near
    1 so they matter)."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax_init_params(_jax_cfg(jnp.float32),
                                           jax.random.PRNGKey(0)))

    def leaf(path, shape):
        name = str(path[-1].key)
        if name.endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.fixture(scope="module")
def tree():
    return _numpy_tree(20261016)


def _pair(tree, jdtype, tdtype):
    jcfg = _jax_cfg(jdtype)
    jmodel = jllama.LlamaModel(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = config_from_jax(jcfg, tdtype)
    model = LlamaModel(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu")
    return jmodel, jparams, model, params


def _tables():
    rng = np.random.default_rng(5)
    perm = rng.permutation(N_PAGES)
    return perm[:2 * COLS].reshape(2, COLS).astype(np.int32)


def _run_both(tree, jdtype, tdtype, prompts, n_decode, chunk):
    """Chunked prefill of two prompts (padded batch of 2), then greedy
    decode; returns per-step logits and tokens of both packages, and both
    arenas."""
    jmodel, jparams, model, params = _pair(tree, jdtype, tdtype)
    table = _tables()
    jarena = jmodel.init_paged_arena(N_PAGES, T)
    arena = model.init_paged_arena(N_PAGES, T)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jlen = jnp.zeros((2,), jnp.int32)
    tlen = torch.zeros((2,), dtype=torch.int32)
    logits_j, logits_t = [], []
    longest = max(len(p) for p in prompts)
    jlast = tlast = None
    for start in range(0, longest, chunk):
        toks = np.zeros((2, chunk), np.int32)
        true = np.zeros((2,), np.int32)
        for i, p in enumerate(prompts):
            part = p[start:start + chunk]
            toks[i, :len(part)] = part
            true[i] = len(part)
        if true.min() == 0:
            raise ValueError("equal chunk counts keep the test simple")
        lj, jarena, jlen = jmodel.paged_prefill_chunk_step(
            jparams, jnp.asarray(toks), jarena, jt, jlen, jnp.asarray(true))
        lt, arena, tlen = model.paged_prefill_chunk_step(
            params, torch.from_numpy(toks), arena, tt, tlen,
            torch.from_numpy(true))
        jlast, tlast = lj, lt
    logits_j.append(np.asarray(jlast, np.float32))
    logits_t.append(tlast.numpy())
    tok_j = np.asarray(jnp.argmax(jlast, axis=-1), np.int32)
    tok_t = tlast.argmax(-1).to(torch.int32)
    toks_j, toks_t = [tok_j.tolist()], [tok_t.tolist()]
    for _ in range(n_decode):
        lj, jarena, jlen = jmodel.paged_decode_step(
            jparams, jnp.asarray(tok_j), jarena, jt, jlen)
        lt, arena, tlen = model.paged_decode_step(params, tok_t, arena, tt,
                                                  tlen)
        logits_j.append(np.asarray(lj, np.float32))
        logits_t.append(lt.numpy())
        tok_j = np.asarray(jnp.argmax(lj, axis=-1), np.int32)
        tok_t = lt.argmax(-1).to(torch.int32)
        toks_j.append(tok_j.tolist())
        toks_t.append(tok_t.tolist())
    return logits_j, logits_t, toks_j, toks_t, jarena, arena


PROMPTS = ([int(t) for t in np.random.default_rng(8).integers(1, 128, 21)],
           [int(t) for t in np.random.default_rng(9).integers(1, 128, 17)])


def test_f32_steps_match_jax_logits_and_arena(tree):
    lj, lt, _, _, jarena, arena = _run_both(
        tree, jnp.float32, torch.float32, PROMPTS, n_decode=3, chunk=8)
    for step, (a, b) in enumerate(zip(lj, lt)):
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0,
                                   err_msg=f"step {step}")
    for name in ("k", "v"):
        np.testing.assert_allclose(arena[name][:, :N_PAGES].numpy(),
                                   np.asarray(jarena[name]), atol=1e-5,
                                   rtol=0)


def test_f32_greedy_16_tokens_token_identical(tree):
    _, _, tj, tt, _, _ = _run_both(tree, jnp.float32, torch.float32,
                                   PROMPTS, n_decode=16, chunk=16)
    assert len(tt) == 17
    assert tt == tj


def test_bf16_steps_match_jax_within_logit_tolerance(tree):
    lj, lt, _, _, _, _ = _run_both(
        tree, jnp.bfloat16, torch.bfloat16, PROMPTS, n_decode=3, chunk=8)
    for step, (a, b) in enumerate(zip(lj, lt)):
        np.testing.assert_allclose(b, a, atol=3e-2, rtol=0,
                                   err_msg=f"step {step}")


def test_params_from_jax_dtypes(tree):
    cfg = config_from_jax(_jax_cfg(jnp.bfloat16), torch.bfloat16)
    params = params_from_jax(tree, cfg, device="cpu")
    assert params["final_norm"].dtype == torch.float32
    assert params["layers"]["attn_norm"].dtype == torch.float32
    assert params["tok_embed"].dtype == torch.bfloat16
    assert params["lm_head"].dtype == torch.bfloat16
    assert params["layers"]["wq"].dtype == torch.bfloat16
    assert params["layers"]["w_down"].shape == (2, 128, 64)


# -- drop-write contract ------------------------------------------------------------

def test_stale_inactive_table_never_clobbers_live_pages(tree):
    """An inactive slot's stale table row can alias an active slot's tail
    page; its write must be dropped (into the sink page), not raced
    against the active slot's genuine write."""
    _, _, model, params = _pair(tree, jnp.float32, torch.float32)
    tok = torch.tensor([5, 7], dtype=torch.int32)
    lengths = torch.zeros(2, dtype=torch.int32)
    active = torch.tensor([True, False])
    outs = []
    for stale_row in ([3, 0, 0, 0], [7, 0, 0, 0]):
        arena = model.init_paged_arena(8, 4)
        pt = torch.tensor([[3, 4, 5, 6], stale_row], dtype=torch.int32)
        _, arena, new_len = model.paged_decode_step(params, tok, arena, pt,
                                                    lengths, active)
        assert new_len.tolist() == [1, 0]
        outs.append(arena["k"][:, 3].clone())
        # nothing but page 3 and the sink page (8) was written
        written = (arena["k"].abs().sum(dim=(0, 2, 3, 4)) > 0).nonzero()
        assert written.flatten().tolist() == [3, 8]
    assert outs[0].abs().sum() > 0, "active slot's write vanished"
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_prefill_rows_past_true_length_write_nothing(tree):
    _, _, model, params = _pair(tree, jnp.float32, torch.float32)
    arena = model.init_paged_arena(8, 4)
    toks = torch.tensor([[9, 8, 7, 6, 5, 4, 3, 2]], dtype=torch.int32)
    pt = torch.tensor([[2, 5, 6, 1]], dtype=torch.int32)
    _, arena, new_len = model.paged_prefill_chunk_step(
        params, toks, arena, pt, torch.zeros(1, dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32))
    assert new_len.tolist() == [5]
    written = (arena["v"].abs().sum(dim=(0, 3, 4)) > 0)   # (P+1, T)
    assert written[2].all() and written[5, 0] and not written[5, 1:].any()
    assert not written[[0, 1, 3, 4, 6, 7]].any()
    assert written[8].any()   # the padded rows went to the sink


# -- configs --------------------------------------------------------------------------

def test_configs_match_the_jax_package():
    for ours, theirs in ((llama3_8b(), jllama.llama3_8b()),
                         (llama31_8b(), jllama.llama31_8b()),
                         (MODEL_CONFIGS["mixtral-8x7b"](),
                          jllama.mixtral_8x7b()),
                         (MODEL_CONFIGS["deepseek-v2-lite"](),
                          jllama.deepseek_v2_lite()),
                         (MODEL_CONFIGS["deepseek-v3"](),
                          jllama.deepseek_v3())):
        assert config_from_jax(theirs, torch.bfloat16) == ours
    assert set(MODEL_CONFIGS) == {"llama3-8b", "llama3-70b", "llama31-8b",
                                  "gemma-7b", "gemma2-9b", "gemma3-12b",
                                  "mistral-7b", "qwen2-7b",
                                  "qwen3-8b", "mla-8b", "mixtral-8x7b",
                                  "deepseek-v2-lite", "deepseek-v3",
                                  "tiny", "tiny-mla", "tiny-moe"}
    assert tiny_llama().embed_dim == jllama.tiny_llama().embed_dim


# an MLA model over a MoE body (every DeepSeek checkpoint) and Mixtral
# with DeepSeek-MoE's shared experts: once refused, both are carried now
# (tests/test_torch_deepseek.py); the name is kept from then
@pytest.mark.parametrize("jcfg", [
    dataclasses.replace(jllama.mixtral_8x7b(), n_shared_experts=2),
    jllama.tiny_mla(n_experts=4, n_experts_per_tok=2)],
    ids=lambda c: c.name)
def test_configs_with_branches_the_port_lacks_are_refused(jcfg):
    cfg = config_from_jax(jcfg, torch.bfloat16)
    for f in ("n_experts", "n_shared_experts", "mla_latent_dim", "name"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


# Gemma 2's fields are served now (tests/test_torch_interleave.py), also
# on configs that carry them alone: Mistral under a window pattern, Qwen2
# with a soft cap
_GEMMA2_FIELDS = ("sliding_window_pattern", "attn_logit_softcap",
                  "query_pre_attn_scalar", "post_norms", "rope_local_theta",
                  "logit_softcap")


@pytest.mark.parametrize("jcfg", [
    dataclasses.replace(jllama.mistral_7b(), sliding_window_pattern=2),
    jllama.gemma2_9b(),
    dataclasses.replace(jllama.qwen2_7b(), attn_logit_softcap=50.0)],
    ids=lambda c: c.name)
def test_config_from_jax_carries_every_field(jcfg):
    cfg = config_from_jax(jcfg, torch.bfloat16)
    for f in _GEMMA2_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.sm_scale == jcfg.sm_scale
    assert cfg.layer_windows() == jcfg.layer_windows()


def test_entry_points_default_to_cuda():
    cfg = tiny_llama()
    if torch.cuda.is_available():
        assert LlamaModel(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator())
