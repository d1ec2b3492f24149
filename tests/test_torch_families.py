"""The other dense families on the port's paged loop, against the JAX
package: Gemma-7B's branches (GeGLU, the embedding scale, zero-centered
norms, a tied head, head_dim 32 at GQA group 1), Mistral's uniform sliding
window (16 tokens over 8-token pages), Qwen2's q/k/v biases (group 3) and
Qwen3's per-head q/k norm, each as a tiny config.

Both packages get the same seeded numpy tree, with every bias and norm
drawn away from identity (the JAX ``init_params`` zeros the biases and
sets the norms to identity, on which a port that ignored them would
pass):

- ``config_from_jax`` carries each field, and the full-size registry
  entries equal the JAX package's;
- paged prefill chunks and decode steps: f32 logits within atol 1e-4 and
  the arena pages within 1e-5, bf16 logits within 3e-2; a 16-token greedy
  loop token-identical in f32 (the windowed config decodes past its
  window with the table entries behind it pointing at garbage pages);
- the contiguous ``forward`` and the dense ``verify_step`` against the JAX
  ones (1e-4);
- multi-LoRA adapters on the q/k/v-bias config with the q/k norm on: the
  bias, then the delta, then the norm, as the JAX model orders them;
- tensor parallelism 2 in one process against one device;
- HF names (``self_attn.*_proj.bias``, ``self_attn.{q,k}_norm.weight``,
  Gemma's tied head) through safetensors files the test writes.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models.convert import \
    to_hf_state_dict as jax_to_hf
from k8s_runpod_kubelet_tpu_torch.models import (MODEL_CONFIGS, LlamaModel,
                                                 init_params)
from k8s_runpod_kubelet_tpu_torch.models.convert import (load_hf,
                                                         to_hf_state_dict)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.quant import (init_quantized_params,
                                                       quantize_params)
from k8s_runpod_kubelet_tpu_torch.parallel import (MeshConfig, make_mesh,
                                                   shard_params)

T = 8          # page tokens
N_PAGES = 40
COLS = 12      # table width: 96 positions a slot
BASE = dict(vocab_size=128, embed_dim=64, n_layers=2, mlp_dim=128,
            max_seq_len=256)
FAMILIES = {
    "gemma": dict(n_heads=2, n_kv_heads=2, head_dim=32, norm_eps=1e-6,
                  tie_embeddings=True, mlp_activation="gelu_tanh",
                  embed_scale=True, norm_zero_centered=True),
    "window": dict(n_heads=4, n_kv_heads=2, sliding_window=16),
    "qkv_bias": dict(n_heads=6, n_kv_heads=2, head_dim=16, norm_eps=1e-6,
                     qkv_bias=True),
    "qk_norm": dict(n_heads=4, n_kv_heads=2, norm_eps=1e-6, qk_norm=True),
}
NAMES = sorted(FAMILIES)
# the fields each family sets away from the Llama defaults
BRANCH_FIELDS = ("sliding_window", "qk_norm", "mlp_activation",
                 "embed_scale", "norm_zero_centered", "qkv_bias",
                 "tie_embeddings", "head_dim", "norm_eps")


def _jax_cfg(name, dtype=jnp.float32, **kw):
    return jllama.tiny_llama(**BASE, **FAMILIES[name], **kw, name=name,
                             dtype=dtype, param_dtype=jnp.float32)


def _numpy_tree(jcfg, seed: int):
    """Seeded numpy parameters in the JAX tree layout: weights 0.05 N(0,1),
    biases 0.3 N(0,1), norms 1 + 0.1 N(0,1) (0.1 N(0,1) when stored
    zero-centered), all away from the JAX init's identity."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    centre = 0.0 if jcfg.norm_zero_centered else 1.0

    def leaf(path, shape):
        name = str(path[-1].key)
        if name.endswith("norm"):
            return (centre + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name.endswith("_b"):
            return (0.3 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.fixture(scope="module")
def trees():
    return {name: _numpy_tree(_jax_cfg(name), 20261018 + i)
            for i, name in enumerate(NAMES)}


def _pair(name, tree, jdtype, tdtype, **kw):
    jcfg = _jax_cfg(name, jdtype, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = config_from_jax(jcfg, tdtype)
    return (jllama.LlamaModel(jcfg), jparams, LlamaModel(cfg, device="cpu"),
            params_from_jax(tree, cfg, device="cpu"))


def _tables():
    """Two slots' page tables; the pages no slot names are garbage."""
    perm = np.random.default_rng(5).permutation(N_PAGES)
    return perm[:2 * COLS].reshape(2, COLS).astype(np.int32)


def _garbage(arena):
    """Every page at 3e4 (and int8 scales at 1): a read of a page the
    slot has not written, or of one behind its window, misses by far."""
    for v in arena.values():
        v.fill_(3e4 if v.dtype.is_floating_point else 100)
    return arena


PROMPTS = ([int(t) for t in np.random.default_rng(8).integers(1, 128, 30)],
           [int(t) for t in np.random.default_rng(9).integers(1, 128, 26)])


def _run_both(name, tree, jdtype, tdtype, n_decode, chunk=8, kw=None,
              adapters=None):
    """Chunked prefill of two prompts (a batch of 2), then greedy decode
    through both packages; returns per-step logits, tokens and arenas.
    ``adapters`` is (JAX stacks, port stacks, ids) for multi-LoRA."""
    jmodel, jparams, model, params = _pair(name, tree, jdtype, tdtype,
                                           **(kw or {}))
    table = _tables()
    jarena = jmodel.init_paged_arena(N_PAGES, T)
    arena = _garbage(model.init_paged_arena(N_PAGES, T))
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jlen = jnp.zeros((2,), jnp.int32)
    tlen = torch.zeros((2,), dtype=torch.int32)
    jad = tad = {}
    if adapters is not None:
        jst, tst, ids = adapters
        jad = dict(adapters=jst, adapter_ids=jnp.asarray(ids))
        tad = dict(adapters=tst, adapter_ids=torch.from_numpy(ids))
    logits_j, logits_t = [], []
    for start in range(0, max(len(p) for p in PROMPTS), chunk):
        toks = np.zeros((2, chunk), np.int32)
        true = np.zeros((2,), np.int32)
        for i, p in enumerate(PROMPTS):
            part = p[start:start + chunk]
            toks[i, :len(part)] = part
            true[i] = len(part)
        lj, jarena, jlen = jmodel.paged_prefill_chunk_step(
            jparams, jnp.asarray(toks), jarena, jt, jlen, jnp.asarray(true),
            **jad)
        lt, arena, tlen = model.paged_prefill_chunk_step(
            params, torch.from_numpy(toks), arena, tt, tlen,
            torch.from_numpy(true), **tad)
    logits_j.append(np.asarray(lj, np.float32))
    logits_t.append(lt.float().numpy())
    tok_j = np.asarray(jnp.argmax(lj, axis=-1), np.int32)
    tok_t = lt.argmax(-1).to(torch.int32)
    toks_j, toks_t = [tok_j.tolist()], [tok_t.tolist()]
    for _ in range(n_decode):
        lj, jarena, jlen = jmodel.paged_decode_step(
            jparams, jnp.asarray(tok_j), jarena, jt, jlen, **jad)
        lt, arena, tlen = model.paged_decode_step(params, tok_t, arena, tt,
                                                  tlen, **tad)
        logits_j.append(np.asarray(lj, np.float32))
        logits_t.append(lt.float().numpy())
        tok_j = np.asarray(jnp.argmax(lj, axis=-1), np.int32)
        tok_t = lt.argmax(-1).to(torch.int32)
        toks_j.append(tok_j.tolist())
        toks_t.append(tok_t.tolist())
    return logits_j, logits_t, toks_j, toks_t, jarena, arena, table


def _written(arena, jarena, table, lengths):
    """The arena rows both packages wrote: each slot's positions below its
    length (the JAX arena starts at zeros, the port's at garbage)."""
    out_t, out_j = [], []
    for slot, n in enumerate(lengths):
        pos = np.arange(n)
        pages, offs = table[slot, pos // T], pos % T
        out_t.append(arena["k"][:, pages, offs].numpy())
        out_j.append(np.asarray(jarena["k"])[:, pages, offs])
    return np.concatenate(out_t, 1), np.concatenate(out_j, 1)


# -- configs ------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_config_from_jax_carries_each_field(name):
    jcfg = _jax_cfg(name)
    cfg = config_from_jax(jcfg, torch.float32)
    for f in BRANCH_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.head_dim_ == jcfg.head_dim_ and cfg.sm_scale == jcfg.sm_scale


def test_full_size_configs_match_the_jax_registry():
    for key, jfn in (("gemma-7b", jllama.gemma_7b),
                     ("gemma2-9b", jllama.gemma2_9b),
                     ("gemma3-12b", jllama.gemma3_12b),
                     ("mistral-7b", jllama.mistral_7b),
                     ("qwen2-7b", jllama.qwen2_7b),
                     ("qwen3-8b", jllama.qwen3_8b),
                     ("llama3-70b", jllama.llama3_70b)):
        assert config_from_jax(jfn(), torch.bfloat16) == MODEL_CONFIGS[key]()
    # a family carrying a Gemma 2 branch alone is carried too
    for jcfg in (dataclasses.replace(jllama.gemma_7b(), logit_softcap=30.0),
                 dataclasses.replace(jllama.mistral_7b(),
                                     attn_logit_softcap=50.0)):
        cfg = config_from_jax(jcfg, torch.bfloat16)
        assert (cfg.logit_softcap, cfg.attn_logit_softcap) == (
            jcfg.logit_softcap, jcfg.attn_logit_softcap)


def test_embed_multiplier_rounds_to_the_compute_dtype():
    assert MODEL_CONFIGS["gemma-7b"]().embed_multiplier == 55.5
    f32 = dataclasses.replace(MODEL_CONFIGS["gemma-7b"](),
                              dtype=torch.float32)
    assert f32.embed_multiplier == float(np.float32(3072 ** 0.5))
    assert MODEL_CONFIGS["qwen3-8b"]().embed_multiplier is None


@pytest.mark.parametrize("name", NAMES)
def test_init_fills_like_the_jax_init(name):
    """Biases start at 0 and norms at identity (0 when zero-centered), as
    the JAX ``init_params`` sets them; the quantized draw equals quantizing
    the drawn tree."""
    jcfg = _jax_cfg(name)
    cfg = config_from_jax(jcfg, torch.bfloat16)
    jtree = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for lname, leaf in params["layers"].items():
        want = np.asarray(jtree["layers"][lname])
        assert leaf.shape == want.shape, lname
        if lname.endswith(("norm", "_b")):
            np.testing.assert_array_equal(leaf.float().numpy(), want)
    np.testing.assert_array_equal(params["final_norm"].numpy(),
                                  np.asarray(jtree["final_norm"]))
    q = init_quantized_params(cfg, torch.Generator().manual_seed(3), 4,
                              "cpu")
    ref = quantize_params(cfg, params, bits=4)
    for lname, leaf in ref["layers"].items():
        got = q["layers"][lname]
        for k, v in (leaf.items() if isinstance(leaf, dict)
                     else [(None, leaf)]):
            torch.testing.assert_close(got[k] if k else got, v, rtol=0,
                                       atol=0)


# -- paged steps ---------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_f32_paged_steps_match_jax(name, trees):
    lj, lt, _, _, jarena, arena, table = _run_both(
        name, trees[name], jnp.float32, torch.float32, n_decode=12)
    for step, (a, b) in enumerate(zip(lj, lt)):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0,
                                   err_msg=f"step {step}")
    got, want = _written(arena, jarena, table,
                         [len(p) + 12 for p in PROMPTS])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_paged_steps_match_jax(name, trees):
    lj, lt, _, _, _, _, _ = _run_both(
        name, trees[name], jnp.bfloat16, torch.bfloat16, n_decode=3)
    for step, (a, b) in enumerate(zip(lj, lt)):
        np.testing.assert_allclose(b, a, atol=3e-2, rtol=0,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("name", NAMES)
def test_f32_greedy_16_tokens_token_identical(name, trees):
    _, _, tj, tt, _, _, _ = _run_both(name, trees[name], jnp.float32,
                                      torch.float32, n_decode=16, chunk=16)
    assert len(tt) == 17 and tt == tj


def test_window_reads_nothing_behind_it(trees):
    """The windowed config after 46 positions: rewriting every page wholly
    behind the window of both slots changes no logit (the entries the
    engine recycles are never read), while rewriting a page inside it
    does."""
    _, _, model, params = _pair("window", trees["window"], jnp.float32,
                                torch.float32)
    table = torch.from_numpy(_tables())
    arena = model.init_paged_arena(N_PAGES, T)
    lengths = torch.zeros(2, dtype=torch.int32)
    toks = torch.tensor([p[:24] for p in PROMPTS], dtype=torch.int32)
    for i in range(0, 24, 8):
        _, arena, lengths = model.paged_prefill_chunk_step(
            params, toks[:, i:i + 8], arena, table, lengths,
            torch.tensor([8, 8], dtype=torch.int32))
    tok = torch.tensor([3, 4], dtype=torch.int32)
    ref, _, _ = model.paged_decode_step(params, tok, arena.copy(), table,
                                        lengths)
    behind = table[:, :1].flatten()   # positions 0..7, behind 24 - 16
    clobbered = {k: v.clone() for k, v in arena.items()}
    for v in clobbered.values():
        v[:, behind] = 3e4
    got, _, _ = model.paged_decode_step(params, tok, clobbered, table,
                                        lengths)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    inside = {k: v.clone() for k, v in arena.items()}
    for v in inside.values():
        v[:, table[:, 2].flatten()] = 3e4
    bad, _, _ = model.paged_decode_step(params, tok, inside, table, lengths)
    assert (bad - ref).abs().max() > 1.0


# -- the contiguous path ---------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_contiguous_forward_and_verify_step_match_jax(name, trees):
    jmodel, jparams, model, params = _pair(name, trees[name], jnp.float32,
                                           torch.float32)
    toks = np.asarray([PROMPTS[0][:24], PROMPTS[1][:24]], np.int32)
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(toks)))
    got = model.forward(params, torch.from_numpy(toks), train=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # prefill 20 tokens, then a K = 4 dense verify past the window
    jcache = jmodel.init_cache(2, 64)
    cache = model.init_cache(2, 64)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(toks[:, :20]), jcache)
    tl, cache = model.prefill(params, torch.from_numpy(toks[:, :20]), cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    jl, _ = jmodel.verify_step(jparams, jnp.asarray(toks[:, 20:]), jcache)
    tl, _ = model.verify_step(params, torch.from_numpy(toks[:, 20:]), cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)


# -- adapters --------------------------------------------------------------------------

def test_adapters_on_the_bias_config_add_bias_then_delta_then_norm(trees):
    """Three rows of adapters (base, a1, a2) on the q/k/v-bias config with
    the q/k norm on: the JAX model adds the bias, then each row's delta,
    then norms q and k; the port's steps must agree at 1e-4."""
    kw = dict(qk_norm=True)
    jcfg = _jax_cfg("qkv_bias", **kw)
    tree = _numpy_tree(jcfg, 77)
    rng = np.random.default_rng(11)
    e, hd = jcfg.embed_dim, jcfg.head_dim_
    dims = {"wq": (e, jcfg.n_heads * hd), "wk": (e, jcfg.n_kv_heads * hd),
            "wv": (e, jcfg.n_kv_heads * hd), "wo": (jcfg.n_heads * hd, e)}
    n_l, rank = jcfg.n_layers, 4
    # slot 0 is zero (the base model), slots 1 and 2 two adapters
    stacks = {}
    for t, (din, dout) in dims.items():
        a = 0.2 * rng.normal(size=(n_l, 3, din, rank))
        b = 0.2 * rng.normal(size=(n_l, 3, rank, dout))
        a[:, 0] = b[:, 0] = 0.0
        scale = np.tile(np.asarray([0.0, 2.0, 1.5]), (n_l, 1))
        stacks[t] = {k: v.astype(np.float32)
                     for k, v in (("a", a), ("b", b), ("scale", scale))}
    tst = {t: {k: torch.from_numpy(v) for k, v in ad.items()}
           for t, ad in stacks.items()}
    jst = jax.tree_util.tree_map(jnp.asarray, stacks)
    for ids in (np.asarray([1, 2], np.int32), np.asarray([0, 2], np.int32)):
        lj, lt, tj, tt, _, _, _ = _run_both(
            "qkv_bias", tree, jnp.float32, torch.float32, n_decode=4,
            kw=kw, adapters=(jst, tst, ids))
        for step, (a, b) in enumerate(zip(lj, lt)):
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=0,
                                       err_msg=f"ids {ids} step {step}")
        assert tt == tj


# -- tensor parallelism ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["qkv_bias", "qk_norm", "gemma"])
def test_tp2_matches_one_device(name, trees):
    """The in-process tensor mesh at 2: biases split with their product's
    columns and added whole after the gather, the q/k norms replicated;
    the logits equal the one-device steps at 1e-5."""
    cfg = config_from_jax(_jax_cfg(name), torch.float32)
    params = params_from_jax(trees[name], cfg, device="cpu")
    one = LlamaModel(cfg, "cpu")
    mesh = make_mesh(MeshConfig(tensor=2))
    two = LlamaModel(cfg, "cpu", mesh)
    sharded = shard_params(cfg, params_from_jax(trees[name], cfg,
                                                device="cpu"), mesh)
    assert sharded["layers"]["wq"].shape[1] == 2
    if cfg.qkv_bias:
        assert sharded["layers"]["wq_b"].shape == (
            2, 2, cfg.n_heads * cfg.head_dim_ // 2)
    table = torch.from_numpy(_tables())
    outs = []
    for model, p in ((one, params), (two, sharded)):
        arena = model.init_paged_arena(N_PAGES, T)
        lengths = torch.zeros(2, dtype=torch.int32)
        toks = torch.tensor([q[:16] for q in PROMPTS], dtype=torch.int32)
        first, arena, lengths = model.paged_prefill_chunk_step(
            p, toks, arena, table, lengths,
            torch.tensor([16, 16], dtype=torch.int32))
        step, _, _ = model.paged_decode_step(
            p, first.argmax(-1).to(torch.int32), arena, table, lengths)
        fwd = model.forward(p, toks, train=False)
        outs.append((first, step, fwd))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-5)


# -- HF checkpoints --------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_hf_names_round_trip_through_safetensors(name, trees, tmp_path):
    """The JAX ``to_hf_state_dict`` written as a 2-shard safetensors dir
    loads through the port's ``load_hf`` equal to ``params_from_jax``; the
    port's own export equals the JAX one key for key."""
    from safetensors.numpy import save_file

    jcfg = _jax_cfg(name)
    cfg = config_from_jax(jcfg, torch.float32)
    sd = jax_to_hf(jcfg, trees[name])
    if cfg.qkv_bias:
        assert "model.layers.1.self_attn.k_proj.bias" in sd
    if cfg.qk_norm:
        assert "model.layers.0.self_attn.q_norm.weight" in sd
    assert ("lm_head.weight" in sd) == (not cfg.tie_embeddings)
    keys = sorted(sd)
    halves = (keys[:len(keys) // 2], keys[len(keys) // 2:])
    index = {}
    for i, part in enumerate(halves):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file({k: np.ascontiguousarray(sd[k]) for k in part},
                  str(tmp_path / fname))
        index.update({k: fname for k in part})
    import json
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": index}))
    got = load_hf(cfg, str(tmp_path), device="cpu")
    want = params_from_jax(trees[name], cfg, device="cpu")
    flat_got = {**{k: v for k, v in got.items() if k != "layers"},
                **got["layers"]}
    flat_want = {**{k: v for k, v in want.items() if k != "layers"},
                 **want["layers"]}
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        torch.testing.assert_close(flat_got[k], v, rtol=0, atol=0)
    back = to_hf_state_dict(cfg, got)
    assert sorted(back) == keys
    for k in keys:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])


def test_hf_checkpoint_with_biases_is_refused_by_a_config_without():
    from k8s_runpod_kubelet_tpu_torch.models.convert import check_keys

    jcfg = _jax_cfg("qkv_bias")
    sd = jax_to_hf(jcfg, _numpy_tree(jcfg, 1))
    plain = config_from_jax(dataclasses.replace(jcfg, qkv_bias=False),
                            torch.float32)
    with pytest.raises(ValueError, match="no place"):
        check_keys(plain, sd.keys())
