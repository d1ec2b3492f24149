"""DeepSeek-MoE in the port against the JAX package, on the CPU.

Two tiny f32 shapes, both drawn from a seed with numpy into the JAX tree
layout and carried over by ``params_from_jax``:

- V2, JAX ``tests/test_mla.py``'s dense-prefix engine shape: MLA over 4
  experts top-2 without renormalization, 2 shared experts and one dense
  layer at width 112 (DeepSeek-V2-Lite's layout);
- V3, JAX ``tiny_mla`` with V3's sigmoid routing (8 experts in 4 groups
  keeping 2, a correction bias, scaling 2.5, renormalized), the low-rank
  q (rank 24), 1 shared expert and one dense layer.

Routers are drawn decisive (normal * 1.0): at the JAX init's 0.02 two
experts score within f32 rounding of each other and the packages may
pick differently. Checked:

- ``route_top_k_v3`` and ``moe_mlp`` with a bias and groups against JAX:
  weights and outputs within 1e-6, ids equal, V3's losses zero;
- ``_mlp`` with shared experts against JAX ``_mlp_block`` within 1e-5;
- ``param_shapes``/``param_count`` of ``deepseek_v2_lite()`` and
  ``deepseek_v3()`` equal to JAX's (from shapes, no tree drawn), and
  ``config_from_jax`` of both equal to the port's registry entries;
- ``params_from_jax`` carries ``prefix_layers``, ``ws_*`` and
  ``router_bias`` bit for bit (the router and its bias in f32);
- ``forward`` logits of both shapes within 1e-4 of JAX's;
- ``init_paged_arena``'s sections, shapes and page bytes equal to JAX's
  in the compute dtype and int8; ``paged_prefill_chunk_step``,
  ``paged_decode_step`` and ``paged_verify_step`` logits within 1e-4 and
  the arenas (the prefix's sections included) within 1e-5 on the same
  page tables;
- the contiguous ``prefill``/``decode_step``/``verify_step`` over
  ``c_pre``/``kr_pre`` within 1e-4 of JAX's, cache sections within 1e-5,
  and ``insert_into_slot`` copying the prefix's sections;
- the page copies of ``PagedKVStore`` (``gather``/``fill_pages``) and its
  ``page_bytes`` cover the ``_pre`` sections;
- ``quantize_params`` (int8 and int4) bit-identical to the JAX quantizer
  on the ``ws_*`` leaves and the ``prefix_layers`` stack, ``router_bias``
  never quantized, and ``init_quantized_params`` equal to quantizing
  ``init_params``'s tree;
- the serve CLI's ``--model deepseek-v2-lite`` parses and ``deepseek-v3``
  is no choice; ``Trainer`` builds over V3 and steps (aux 0 under sigmoid
  routing), and ``shard_params`` refuses the DeepSeek fields by name.
"""

import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import moe as jmoe
from k8s_runpod_kubelet_tpu.models import quant as jquant
from k8s_runpod_kubelet_tpu.workloads.serving.kv_manager import \
    PagedKVStore as JaxPagedKVStore
from k8s_runpod_kubelet_tpu_torch.models import (MODEL_CONFIGS, LlamaModel,
                                                 deepseek_v2_lite,
                                                 deepseek_v3, init_params)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.llama import param_shapes
from k8s_runpod_kubelet_tpu_torch.models.moe import moe_mlp, route_top_k_v3
from k8s_runpod_kubelet_tpu_torch.models.quant import (init_quantized_params,
                                                       quantize_params)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.kv_manager import \
    PagedKVStore

DIMS = dict(vocab_size=128, embed_dim=64, n_layers=3, n_heads=4,
            n_kv_heads=4, head_dim=16, mla_latent_dim=32, mla_rope_dim=8,
            mlp_dim=48, max_seq_len=256, n_dense_prefix=1,
            dense_prefix_mlp_dim=112)
SHAPES = {
    "v2": dict(n_experts=4, n_experts_per_tok=2, n_shared_experts=2,
               router_norm_topk=False),
    "v3": dict(mla_q_lora_rank=24, n_experts=8, n_experts_per_tok=2,
               n_shared_experts=1, router_norm_topk=True,
               router_sigmoid_bias=True, router_n_group=4,
               router_topk_group=2, routed_scaling_factor=2.5),
}
T, N_PAGES, COLS = 8, 24, 8


def jax_cfg(shape: str, **kw):
    return jllama.tiny_mla(**DIMS, **SHAPES[shape], dtype=jnp.float32,
                           param_dtype=jnp.float32, **kw)


def numpy_tree(jcfg, seed: int = 20261018):
    """Seeded numpy parameters in the JAX tree layout: norms near 1, the
    router decisive (normal * 1.0), V3's correction bias normal * 0.3 (so
    the biased selection differs from the raw one), the rest normal *
    0.08."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(jcfg, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        name = str(path[-1].key)
        scale = {"router": 1.0, "router_bias": 0.3}.get(name, 0.08)
        if name.endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def pair(shape: str, **kw):
    """(JAX model, JAX params, port model, port params, numpy tree)."""
    jcfg = jax_cfg(shape, **kw)
    tree = numpy_tree(jcfg)
    cfg = config_from_jax(jcfg, torch.float32)
    return (jllama.LlamaModel(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
            LlamaModel(cfg, device="cpu"),
            params_from_jax(tree, cfg, device="cpu"), tree)


# -- routing and the MLP ------------------------------------------------------------

@pytest.mark.parametrize("norm_topk", [True, False], ids=["renorm", "raw"])
def test_route_top_k_v3_matches_jax(norm_topk):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(32, 16)).astype(np.float32)
    bias = (0.3 * rng.normal(size=(16,))).astype(np.float32)
    kw = dict(n_group=4, topk_group=2, norm_topk=norm_topk,
              routed_scaling=2.5)
    jw, jid, js = jmoe.route_top_k_v3(jnp.asarray(logits), 3,
                                      correction_bias=jnp.asarray(bias), **kw)
    tw, tid, ts = route_top_k_v3(torch.from_numpy(logits), 3,
                                 correction_bias=torch.from_numpy(bias), **kw)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    # the selection is group-limited: every pick lies in one of the 2
    # groups (of 4 experts) the token keeps
    groups = tid.numpy() // 4
    assert all(len(set(row)) <= 2 for row in groups)


def test_moe_mlp_with_bias_and_groups_matches_jax():
    rng = np.random.default_rng(2)
    e, m, x = 32, 24, 8
    h = rng.normal(size=(2, 5, e)).astype(np.float32)
    router = rng.normal(size=(e, x)).astype(np.float32)
    bias = (0.3 * rng.normal(size=(x,))).astype(np.float32)
    wg, wu = (0.1 * rng.normal(size=(2, x, e, m))).astype(np.float32)
    wd = (0.1 * rng.normal(size=(x, m, e))).astype(np.float32)
    kw = dict(n_experts_per_tok=2, capacity_factor=x / 2, norm_topk=True,
              router_n_group=4, router_topk_group=2, routed_scaling=2.5)
    jy, jaux, jz = jmoe.moe_mlp(
        jnp.asarray(h), jnp.asarray(router), jnp.asarray(wg), jnp.asarray(wu),
        jnp.asarray(wd), activation=jax.nn.silu, dtype=jnp.float32,
        router_bias=jnp.asarray(bias), **kw)
    ty, taux, tz = moe_mlp(
        torch.from_numpy(h), torch.from_numpy(router), torch.from_numpy(wg),
        torch.from_numpy(wu), torch.from_numpy(wd), dtype=torch.float32,
        router_bias=torch.from_numpy(bias), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=0)
    assert float(jaux) == float(taux) == 0.0
    assert float(jz) == float(tz) == 0.0


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_mlp_with_shared_experts_matches_jax_mlp_block(shape):
    jmodel, jparams, model, params, _ = pair(shape)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    for stack, layer in (("prefix_layers", 0), ("layers", 1)):
        jlp = jax.tree_util.tree_map(lambda a: a[layer], jparams[stack])
        jcfg = (jmodel.cfg.prefix_cfg() if stack == "prefix_layers"
                else jmodel.cfg)
        ref, _ = jllama._mlp_block(jnp.asarray(x), jlp, jcfg, None,
                                   train=False)
        got = model._paged_mlp(torch.from_numpy(x), params[stack], layer)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0, err_msg=stack)
    assert ("ws_gate" in params["layers"]
            and "ws_gate" not in params["prefix_layers"])


# -- configs and trees --------------------------------------------------------------

@pytest.mark.parametrize("name", ["deepseek-v2-lite", "deepseek-v3"])
def test_shapes_and_count_equal_jax(name):
    jcfg = getattr(jllama, name.replace("-", "_"))()
    cfg = MODEL_CONFIGS[name]()
    got = config_from_jax(jcfg, torch.bfloat16)
    assert got == cfg
    want = jax.eval_shape(lambda: jax_init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    shapes = param_shapes(cfg)
    assert set(shapes) == set(want)
    for stack in ("layers", "prefix_layers"):
        assert {k: tuple(s) for k, s in shapes[stack].items()} == \
            {k: v.shape for k, v in want[stack].items()}, stack
    assert cfg.param_count == jcfg.param_count
    assert cfg.param_count == sum(math.prod(v.shape) for v in
                                  jax.tree_util.tree_leaves(want))
    if name == "deepseek-v2-lite":
        assert cfg.param_count == 15_706_484_224


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_params_from_jax_carries_the_deepseek_leaves(shape):
    *_, params, tree = pair(shape)
    assert set(params["prefix_layers"]) == set(tree["prefix_layers"])
    for stack, names in (("prefix_layers", ("w_gate", "w_up", "w_down")),
                         ("layers", ("ws_gate", "ws_up", "ws_down",
                                     "router") + (("router_bias",)
                                                  if shape == "v3" else ()))):
        for n in names:
            assert params[stack][n].dtype == torch.float32
            np.testing.assert_array_equal(params[stack][n].numpy(),
                                          tree[stack][n], err_msg=n)
    cfg = config_from_jax(jax_cfg(shape), torch.bfloat16)
    served = params_from_jax(tree, cfg, device="cpu")
    assert served["layers"]["ws_down"].dtype == torch.bfloat16
    assert served["prefix_layers"]["w_down"].dtype == torch.bfloat16
    assert served["layers"]["router"].dtype == torch.float32
    if shape == "v3":
        assert served["layers"]["router_bias"].dtype == torch.float32


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_matches_jax(shape):
    jmodel, jparams, model, params, _ = pair(shape)
    toks = np.random.default_rng(4).integers(1, 128, (2, 11)).astype(np.int32)
    # both route at the training capacity (capacity_factor 1.25: some
    # assignments drop, the same ones in both)
    ref = np.asarray(jmodel.forward(jparams, jnp.asarray(toks)))
    got = model.forward(params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


# -- the paged steps ----------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_arena_sections_and_page_bytes_equal_jax(quant):
    jmodel, _, model, _, _ = pair("v2")
    jarena = jmodel.init_paged_arena(N_PAGES + 1, T, quantize=quant)
    arena = model.init_paged_arena(N_PAGES, T, quantize=quant)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in arena.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jarena.items()}
    want = {"c", "kr", "c_pre", "kr_pre"}
    if quant:
        want |= {n + "_scale" for n in want}
    assert set(arena) == want
    assert arena["c_pre"].shape[0] == 1 and arena["c"].shape[0] == 2
    store = PagedKVStore(N_PAGES, T, arena)
    jstore = JaxPagedKVStore(N_PAGES + 1, T,
                             lambda: jmodel.init_cache(1, 4 * T, quant))
    assert {k: v.shape for k, v in jstore.arena.items()} == \
        {k: v.shape for k, v in jarena.items()}
    assert store.page_bytes == jstore.page_bytes == \
        store.page_bytes_per_shard
    # three layers of (32 + 8) latents a position: f32 4 bytes each; int8
    # 1 byte each plus two f32 scales
    assert store.page_bytes == 3 * T * ((32 + 8 + 8) if quant else 40 * 4)


def run_paged(shape: str, quant: bool):
    """Chunked prefill of two prompts (a padded batch of 2), three greedy
    decode steps, then a 3-token verify step: the per-step logits of both
    packages and both arenas."""
    jmodel, jparams, model, params, _ = pair(shape)
    table = np.random.default_rng(5).permutation(N_PAGES)[:2 * COLS] \
        .reshape(2, COLS).astype(np.int32)
    jarena = jmodel.init_paged_arena(N_PAGES, T, quantize=quant)
    arena = model.init_paged_arena(N_PAGES, T, quantize=quant)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jlen, tlen = jnp.zeros((2,), jnp.int32), torch.zeros(2, dtype=torch.int32)
    prompts = [np.random.default_rng(s).integers(1, 128, n)
               for s, n in ((8, 21), (9, 17))]
    out = []
    for start in range(0, 21, 8):
        toks = np.zeros((2, 8), np.int32)
        true = np.zeros((2,), np.int32)
        for i, p in enumerate(prompts):
            part = p[start:start + 8]
            toks[i, :len(part)] = part
            true[i] = len(part)
        lj, jarena, jlen = jmodel.paged_prefill_chunk_step(
            jparams, jnp.asarray(toks), jarena, jt, jlen, jnp.asarray(true))
        lt, arena, tlen = model.paged_prefill_chunk_step(
            params, torch.from_numpy(toks), arena, tt, tlen,
            torch.from_numpy(true))
    out.append((np.asarray(lj), lt.numpy()))
    tok = np.asarray(lj).argmax(-1).astype(np.int32)
    for _ in range(3):
        lj, jarena, jlen = jmodel.paged_decode_step(
            jparams, jnp.asarray(tok), jarena, jt, jlen)
        lt, arena, tlen = model.paged_decode_step(
            params, torch.from_numpy(tok), arena, tt, tlen)
        out.append((np.asarray(lj), lt.numpy()))
        tok = np.asarray(lj).argmax(-1).astype(np.int32)
    toks = np.random.default_rng(6).integers(1, 128, (2, 3)).astype(np.int32)
    n_tok = np.array([3, 2], np.int32)
    lj, jarena = jmodel.paged_verify_step(
        jparams, jnp.asarray(toks), jarena, jt, jlen,
        n_tokens=jnp.asarray(n_tok))
    lt, arena = model.paged_verify_step(
        params, torch.from_numpy(toks), arena, tt, tlen,
        n_tokens=torch.from_numpy(n_tok))
    lj = np.asarray(lj)
    out += [(lj[0], lt[0].numpy()), (lj[1, :2], lt[1, :2].numpy())]
    return out, jarena, arena


def assert_sections_close(got_tree, ref_tree, names, cut=None):
    """Latent sections within 1e-5 (int8 rows within one rounding step,
    scales within rtol 1e-5); ``cut`` slices the port's page axis (its
    sink page)."""
    for name in names:
        got = got_tree[name]
        got = (got[:, :cut] if cut is not None else got).numpy()
        ref = np.asarray(ref_tree[name])
        if name.endswith("scale"):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0,
                                       err_msg=name)
        elif got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - ref).max() <= 1, name
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("shape,quant", [("v2", False), ("v2", True),
                                         ("v3", False)],
                         ids=["v2", "v2_int8", "v3"])
def test_paged_steps_match_jax(shape, quant):
    steps, jarena, arena = run_paged(shape, quant)
    for i, (ref, got) in enumerate(steps):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
    assert set(arena) == set(jarena)
    assert arena["c_pre"].abs().sum() > 0
    assert_sections_close(arena, jarena, arena, cut=N_PAGES)


# -- the contiguous loop ------------------------------------------------------------

@pytest.mark.parametrize("shape,quant", [("v2", False), ("v2", True),
                                         ("v3", False)],
                         ids=["v2", "v2_int8", "v3"])
def test_contiguous_steps_match_jax(shape, quant):
    """A batch-1 prefill inserted into slot 1 of a 2-row cache, two
    decode steps (slot 0 inactive) and a 3-token verify."""
    jmodel, jparams, model, params, _ = pair(shape)
    prompt = np.random.default_rng(7).integers(1, 128, (1, 13)) \
        .astype(np.int32)
    jsingle = jmodel.init_cache(1, 48, quantize=quant)
    single = model.init_cache(1, 48, quantize=quant)
    assert set(single) == set(jsingle)
    assert single["c_pre"].shape == (1, 1, 48, 32)
    lj, jsingle = jmodel.prefill(jparams, jnp.asarray(prompt), jsingle)
    lt, single = model.prefill(params, torch.from_numpy(prompt), single)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    jcache = jmodel.insert_into_slot(jmodel.init_cache(2, 48, quant),
                                     jsingle, 1)
    cache = model.insert_into_slot(model.init_cache(2, 48, quant), single, 1)
    assert torch.equal(cache["c_pre"][:, 1], single["c_pre"][:, 0])
    active = np.array([False, True])
    tok = np.array([0, int(np.asarray(lj).argmax())], np.int32)
    for _ in range(2):
        lj, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                        jnp.asarray(active))
        lt, cache = model.decode_step(params, torch.from_numpy(tok), cache,
                                      torch.from_numpy(active))
        np.testing.assert_allclose(lt[1].numpy(), np.asarray(lj)[1],
                                   atol=1e-4, rtol=0)
        tok = np.asarray(lj).argmax(-1).astype(np.int32)
    toks = np.random.default_rng(8).integers(1, 128, (2, 3)).astype(np.int32)
    lj, jcache = jmodel.verify_step(jparams, jnp.asarray(toks), jcache,
                                    jnp.asarray(active))
    lt, cache = model.verify_step(params, torch.from_numpy(toks), cache,
                                  torch.from_numpy(active))
    np.testing.assert_allclose(lt[1].numpy(), np.asarray(lj)[1], atol=1e-4,
                               rtol=0)
    assert_sections_close(cache, jcache,
                          [n for n in cache if n != "index"])


def test_page_copies_cover_the_prefix_sections():
    """``fill_pages`` from a prefilled single cache, then ``gather`` into a
    fresh one: every section, ``c_pre``/``kr_pre`` included, round-trips."""
    _, _, model, params, _ = pair("v2")
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        1, 128, (1, 2 * T)).astype(np.int32))
    single = model.init_cache(1, 4 * T)
    model.prefill(params, prompt, single)
    store = PagedKVStore(N_PAGES, T, model.init_paged_arena(N_PAGES, T))
    pages = store.alloc_run(2)
    store.fill_pages(single, pages, 0)
    back = store.gather(pages, model.init_cache(1, 4 * T))
    for name in ("c", "kr", "c_pre", "kr_pre"):
        assert back[name][:, 0, :2 * T].abs().sum() > 0, name
        assert torch.equal(back[name][:, 0, :2 * T],
                           single[name][:, 0, :2 * T]), name
    assert int(back["index"][0]) == 2 * T


# -- quantization -------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_equals_the_jax_quantizer(bits):
    *_, params, tree = pair("v3")
    cfg = config_from_jax(jax_cfg("v3"), torch.float32)
    got = quantize_params(cfg, params, bits=bits)
    want = jquant.quantize_params(jax_cfg("v3"), tree, bits=bits,
                                  commit=False)
    kind = "q8" if bits == 8 else "q4"
    for stack, names in (("prefix_layers", ("w_gate", "w_up", "w_down",
                                            "w_qa", "w_qb", "w_dkv")),
                         ("layers", ("ws_gate", "ws_up", "ws_down",
                                     "we_gate", "we_down"))):
        for n in names:
            for k in (kind, "scale"):
                np.testing.assert_array_equal(
                    got[stack][n][k].numpy(), np.asarray(want[stack][n][k]),
                    err_msg=f"{stack}/{n}/{k}")
    for n in ("router", "router_bias"):
        assert isinstance(got["layers"][n], torch.Tensor)
        assert got["layers"][n].dtype == torch.float32


def test_init_quantized_params_equals_quantizing_the_drawn_tree():
    cfg = dataclasses.replace(config_from_jax(jax_cfg("v2"), torch.bfloat16))
    a = init_quantized_params(cfg, torch.Generator().manual_seed(5), 4,
                              "cpu")
    b = quantize_params(cfg, init_params(cfg, torch.Generator().manual_seed(5),
                                         "cpu"), 4)
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert torch.equal(leaf, flat_b[path]), path
    assert set(a["prefix_layers"]["w_down"]) == {"q4", "scale"}


# -- HF checkpoints -----------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_hf_safetensors_load_and_export_match_jax(tmp_path, shape):
    """JAX ``to_hf_state_dict`` written as safetensors (V2: the dense
    prefix and shared experts; V3: the low-rank q and the correction bias
    too) loads through the port's ``load_hf`` into ``params_from_jax``'s
    tree, bit for bit, and the port's ``to_hf_state_dict`` gives JAX's
    names and values."""
    from safetensors.torch import save_file

    from k8s_runpod_kubelet_tpu.models import convert as jconvert
    from k8s_runpod_kubelet_tpu_torch.models import convert

    jcfg = jax_cfg(shape)
    tree = numpy_tree(jcfg)
    cfg = config_from_jax(jcfg, torch.float32)
    sd = jconvert.to_hf_state_dict(jcfg, tree)
    assert "model.layers.0.mlp.gate_proj.weight" in sd
    assert "model.layers.1.mlp.shared_experts.up_proj.weight" in sd
    if shape == "v3":
        assert "model.layers.2.mlp.gate.e_score_correction_bias" in sd
        assert "model.layers.0.self_attn.q_a_proj.weight" in sd
    save_file({k: torch.from_numpy(np.array(v, order="C"))
               for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
    got = convert.load_hf(cfg, str(tmp_path), device="cpu")
    want = params_from_jax(tree, cfg, device="cpu")
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(dict(jax.tree_util.tree_leaves_with_path(got))) == set(flat)
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        assert leaf.dtype == flat[path].dtype, path
        assert torch.equal(leaf, flat[path]), path
    ours = convert.to_hf_state_dict(cfg, want)
    assert set(ours) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_hf_dense_prefix_mismatch_is_refused_with_jax_message():
    from k8s_runpod_kubelet_tpu.models import convert as jconvert
    from k8s_runpod_kubelet_tpu_torch.models import convert

    jcfg = jax_cfg("v2")
    sd = {k: None for k in jconvert.to_hf_state_dict(jcfg,
                                                     numpy_tree(jcfg))}
    uniform = config_from_jax(dataclasses.replace(
        jcfg, n_dense_prefix=0, dense_prefix_mlp_dim=None), torch.float32)
    with pytest.raises(ValueError, match="layer 0 has a dense MLP where "
                       "experts are expected.*n_dense_prefix=0"):
        convert.load_hf(uniform, sd, device="cpu")
    deeper = config_from_jax(dataclasses.replace(jcfg, n_layers=4,
                                                 n_dense_prefix=2),
                             torch.float32)
    with pytest.raises(ValueError, match="layer 1 has experts but the "
                       "config expects a dense prefix of 2"):
        convert.load_hf(deeper, sd, device="cpu")


# -- the CLI and the refusals -------------------------------------------------------

def test_serve_cli_offers_v2_lite_and_not_v3():
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    args = serve_main.parse_args(["--model", "deepseek-v2-lite", "--int4",
                                  "--kv-int8"])
    assert args.model == "deepseek-v2-lite" and args.int4 and args.kv_int8
    with pytest.raises(SystemExit):
        serve_main.parse_args(["--model", "deepseek-v3"])


def test_trainer_and_shard_params_refuse_the_deepseek_fields():
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
    from k8s_runpod_kubelet_tpu_torch.parallel.sharding import shard_params
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (TrainConfig,
                                                              Trainer)

    cfg = config_from_jax(jax_cfg("v3"), torch.float32)
    # the trainer no longer refuses them: it builds and steps (the parity
    # with the JAX trainer is test_torch_moe_train.py's)
    tr = Trainer(cfg, TrainConfig(batch_size=1, seq_len=8, warmup_steps=1),
                 device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 9),
                           generator=torch.Generator().manual_seed(0))
    m = tr.step_fn(tr.params, tr.opt_state, tokens)
    assert math.isfinite(float(m["loss"])) and float(m["aux_loss"]) == 0.0
    mesh = make_mesh(MeshConfig(data=1, tensor=2))
    with pytest.raises(ValueError, match="DeepSeek-MoE.*n_shared_experts"):
        shard_params(cfg, {"layers": {}}, mesh)
