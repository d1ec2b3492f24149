"""The port's MLA serving path against the JAX package's, on the CPU.

- ``rope_frequencies``'s YaRN branch and JAX's, each against an f64
  evaluation of the same f32 frequencies (the port's), for the
  ``deepseek_v2_lite`` scaling, an attention factor folded into the
  tables, and an untruncated ramp: table values below 1 within atol 1e-6,
  values of 1 and more within 4 ulps (both libraries' f32 cos/sin read at
  most 1.01 ulps there, at angles up to 255 rad, and 8.3e-8 below 1);
  ``apply_rope`` of both sides through the same f32 tables within 4 ulps
  of the rotation's term magnitude |x1 c| + |x2 s| of its f64 evaluation
  (atol 1e-6 where that is below 1; both read at most 1.61 ulps, and
  2.1e-7 below 1); ``yarn_mscale_sq`` exactly equal;
- the four MLA plains (``_paged_attention_multi_mla{,_quant}_plain`` and
  the single-token ``_paged_attention_mla{,_quant}_plain``) against the
  JAX references (``use_pallas=False``) and, at one tiny shape each,
  against the Pallas kernels in interpret mode, in f32 (atol 1e-5: f32
  softmax and products summed in other orders). Several lengths a batch
  (one position, one full page, a partly filled last page), K = 1 and
  K > 1, tables whose entries past ceil(len/T) name pages of large finite
  garbage, and int8 latents with ``_kv_quant`` scales;
- ``_mla_project`` for full-rank q and for ``mla_q_lora_rank`` (atol
  1e-5);
- ``paged_prefill_chunk_step``, ``paged_decode_step`` and
  ``paged_verify_step`` on f32 ``tiny_mla`` against the JAX ``LlamaModel``
  on the same weights through ``params_from_jax``: logits within atol
  1e-4, the latent arena (sink page excluded) within 1e-5; with int8
  latents (int8 rows within one rounding step, scales within rtol 1e-5:
  an f32 ulp may move a rounding, so the tokens are also held by the
  engine test), with YaRN and with ``mla_q_lora_rank``;
- the drop-write contract: rows past ``n_tokens`` and inactive slots write
  only the sink page, in every latent section;
- ``quantize_params`` on MLA trees bit-identical to the JAX quantizer's
  (``w_dkv``, ``w_qa``, ``w_qb`` quantized; ``w_uk``/``w_uv`` not);
- configs: ``mla_8b`` and ``tiny_mla`` equal to the JAX package's through
  ``config_from_jax``; MoE and dense-prefix configs, and ``forward`` on
  MLA, raise.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import quant as jquant
from k8s_runpod_kubelet_tpu.ops import attention as jattn
from k8s_runpod_kubelet_tpu.ops.rope import apply_rope as jax_apply_rope
from k8s_runpod_kubelet_tpu.ops.rope import \
    rope_frequencies as jax_rope_frequencies
from k8s_runpod_kubelet_tpu_torch.models import (MODEL_CONFIGS, LlamaModel,
                                                 mla_8b, tiny_llama,
                                                 tiny_mla)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.llama import (_kv_quant,
                                                       yarn_mscale_sq)
from k8s_runpod_kubelet_tpu_torch.models.quant import quantize_params
from k8s_runpod_kubelet_tpu_torch.ops import (apply_rope, paged_attention_mla,
                                              paged_attention_mla_quant,
                                              paged_attention_multi_mla,
                                              paged_attention_multi_mla_quant,
                                              rope_frequencies)
from k8s_runpod_kubelet_tpu_torch.ops.rope import inv_frequencies
from k8s_runpod_kubelet_tpu_torch.ops.attention import (
    _paged_attention_mla_plain, _paged_attention_mla_quant_plain,
    _paged_attention_multi_mla_plain, _paged_attention_multi_mla_quant_plain)

GARBAGE = 3e4  # stale pages hold large finite values
DS_YARN = jllama.deepseek_v2_lite().rope_scaling
YARN = {
    "deepseek_v2_lite": DS_YARN,
    "attention_factor": {"rope_type": "yarn", "factor": 8.0,
                         "original_max_position_embeddings": 64},
    "untruncated": {"type": "yarn", "factor": 4.0, "beta_fast": 16,
                    "beta_slow": 2, "mscale": 1.0, "mscale_all_dim": 0.5,
                    "original_max_position_embeddings": 128,
                    "truncate": False},
}


# -- rope: YaRN ---------------------------------------------------------------------

# f32 results against an f64 evaluation: ulps of the compared magnitude
# where it is 1 or more, atol 1e-6 below 1 (see the module docstring for
# the errors measured)
YARN_ULPS, YARN_ATOL = 4, 1e-6


def _within_f64(got, ref, mag, what):
    """|got - ref| <= YARN_ULPS ulps of the f32 magnitude ``mag`` where it
    is >= 1, else <= YARN_ATOL; ref and mag in f64."""
    err = np.abs(np.asarray(got, np.float64) - ref)
    ulp = np.spacing(mag.astype(np.float32)).astype(np.float64)
    tol = np.where(mag >= 1, YARN_ULPS * ulp, YARN_ATOL)
    worst = float((err / tol).max())
    assert worst <= 1, f"{what}: {worst:.2f}x the tolerance"


@pytest.mark.parametrize("name", sorted(YARN))
def test_yarn_tables_match_jax(name):
    """The port's tables and JAX's, each against cos and sin in f64 of the
    same f32 angles t * f (f the port's f32 frequencies; an f32 product
    rounds the same in both libraries) times the attention factor: the
    two implement one function, each within its f32 cos/sin error, which
    a direct comparison of the two would double."""
    sc = YARN[name]
    for dim, theta in ((64, 10_000.0), (16, 500_000.0)):
        f, af = inv_frequencies(dim, 256, theta, sc)
        ang = np.outer(np.arange(256, dtype=np.float32), f.numpy())
        assert ang.dtype == np.float32
        cos64 = np.cos(ang.astype(np.float64)) * af
        sin64 = np.sin(ang.astype(np.float64)) * af
        cos_j, sin_j = jax_rope_frequencies(dim, 256, theta, sc)
        cos_t, sin_t = rope_frequencies(dim, 256, theta, sc)
        for side, c, s in (("port", cos_t.numpy(), sin_t.numpy()),
                           ("jax", cos_j, sin_j)):
            _within_f64(c, cos64, np.abs(cos64), f"{side} cos, D={dim}")
            _within_f64(s, sin64, np.abs(sin64), f"{side} sin, D={dim}")
    # the rotation, both sides through the same f32 tables (the port's),
    # against it in f64
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 256, size=(2, 5)).astype(np.int32)
    c = cos_t.numpy().astype(np.float64)[pos][:, :, None]
    s = sin_t.numpy().astype(np.float64)[pos][:, :, None]
    x1, x2 = x[..., :8].astype(np.float64), x[..., 8:].astype(np.float64)
    ref = np.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], -1)
    mag = np.concatenate([np.abs(x1 * c) + np.abs(x2 * s)] * 2, -1)
    jax_out = jax_apply_rope(jnp.asarray(x), jnp.asarray(cos_t.numpy()),
                             jnp.asarray(sin_t.numpy()), jnp.asarray(pos))
    out = apply_rope(torch.from_numpy(x), cos_t, sin_t,
                     torch.from_numpy(pos).long())
    _within_f64(out.numpy(), ref, mag, "port apply_rope")
    _within_f64(jax_out, ref, mag, "jax apply_rope")


def test_yarn_attention_factor_is_folded_into_the_tables():
    cos, sin = rope_frequencies(16, 8, 10_000.0, YARN["attention_factor"])
    af = 0.1 * np.log(8.0) + 1.0
    np.testing.assert_allclose(cos[0].numpy(), np.full(8, af), rtol=1e-6)
    np.testing.assert_allclose((cos ** 2 + sin ** 2).numpy(), af * af,
                               rtol=1e-5)


@pytest.mark.parametrize("scaling", [None, DS_YARN, YARN["untruncated"],
                                     YARN["attention_factor"]],
                         ids=["none", "deepseek", "untruncated", "no_mscale"])
def test_yarn_mscale_sq_is_exact(scaling):
    jcfg = jllama.tiny_mla(rope_scaling=scaling)
    cfg = config_from_jax(jcfg, torch.float32)
    assert yarn_mscale_sq(cfg) == jllama.yarn_mscale_sq(jcfg)
    assert cfg.sm_scale == (32 + 16) ** -0.5 * jllama.yarn_mscale_sq(jcfg)


# -- the four MLA plains ----------------------------------------------------------

R, DR, HQ, T = 32, 16, 4, 8


def _mla_case(b, kq, lengths, cols=6, seed=0):
    """Latent pages in random order; table entries past ceil(len/T) name
    pages of large finite garbage."""
    rng = np.random.default_rng(seed)
    live = [-(-n // T) for n in lengths]
    n_garbage = 3
    n_pages = sum(live) + n_garbage
    perm = rng.permutation(n_pages)
    table = np.zeros((b, cols), np.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        table[i, live[i]:] = garbage[np.arange(cols - live[i]) % n_garbage]
    c = rng.normal(size=(n_pages, T, R)).astype(np.float32)
    kr = rng.normal(size=(n_pages, T, DR)).astype(np.float32)
    c[garbage] = GARBAGE
    kr[garbage] = -GARBAGE
    q_lat = rng.normal(size=(b, kq, HQ, R)).astype(np.float32)
    q_rope = rng.normal(size=(b, kq, HQ, DR)).astype(np.float32)
    return q_lat, q_rope, c, kr, table, np.asarray(lengths, np.int32)


def _pages(c, kr, quant):
    """The page arguments: f32 latents, or int8 ones with the model's own
    per-position ``_kv_quant`` scales."""
    if not quant:
        return [c, kr]
    (cq, cs), (kq, ks) = (_kv_quant(torch.from_numpy(a)) for a in (c, kr))
    return [cq.numpy(), kq.numpy(), cs.numpy(), ks.numpy()]


MULTI = {False: (_paged_attention_multi_mla_plain,
                 jattn.paged_attention_multi_mla, paged_attention_multi_mla),
         True: (_paged_attention_multi_mla_quant_plain,
                jattn.paged_attention_multi_mla_quant,
                paged_attention_multi_mla_quant)}
SINGLE = {False: (_paged_attention_mla_plain, jattn.paged_attention_mla,
                  paged_attention_mla),
          True: (_paged_attention_mla_quant_plain,
                 jattn.paged_attention_mla_quant, paged_attention_mla_quant)}
CASES = {"decode": (3, 1, [1, 8, 29]), "k4": (3, 4, [4, 13, 40]),
         "k9": (2, 9, [9, 33])}
SCALE = 0.17


def _both(plain, jfn, q_lat, q_rope, pages, table, lens, **jkw):
    args = [q_lat, q_rope, *pages, table, lens]
    got = plain(*(torch.from_numpy(a) for a in args), sm_scale=SCALE)
    ref = jfn(*(jnp.asarray(a) for a in args), sm_scale=SCALE, **jkw)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("quant", [False, True], ids=["latent", "int8_latent"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_plains_match_jax_reference(case, quant):
    b, kq, lengths = CASES[case]
    q_lat, q_rope, c, kr, table, lens = _mla_case(b, kq, lengths)
    plain, jfn, _ = MULTI[quant]
    got, ref = _both(plain, jfn, q_lat, q_rope, _pages(c, kr, quant), table,
                     lens, use_pallas=False)
    assert got.shape == (b, kq, HQ, R) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["latent", "int8_latent"])
def test_multi_plains_match_jax_kernel_in_interpret_mode(quant):
    q_lat, q_rope, c, kr, table, lens = _mla_case(2, 3, [3, 21], cols=4,
                                                  seed=1)
    plain, jfn, _ = MULTI[quant]
    got, ref = _both(plain, jfn, q_lat, q_rope, _pages(c, kr, quant), table,
                     lens, interpret=True)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["latent", "int8_latent"])
def test_single_token_plains_match_jax_kernel_and_reference(quant):
    q_lat, q_rope, c, kr, table, lens = _mla_case(3, 1, [1, 16, 23], cols=4,
                                                  seed=2)
    plain, jfn, _ = SINGLE[quant]
    pages = _pages(c, kr, quant)
    for jkw in ({"use_pallas": False}, {"interpret": True}):
        got, ref = _both(plain, jfn, q_lat[:, 0], q_rope[:, 0], pages, table,
                         lens, **jkw)
        assert got.shape == (3, HQ, R)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    multi, _, _ = MULTI[quant]
    np.testing.assert_array_equal(
        got, multi(*(torch.from_numpy(a) for a in
                     [q_lat, q_rope, *pages, table, lens]),
                   sm_scale=SCALE)[:, 0].numpy())


@pytest.mark.parametrize("single", [False, True], ids=["multi", "single"])
@pytest.mark.parametrize("quant", [False, True], ids=["latent", "int8_latent"])
def test_cpu_wrappers_take_the_plains_and_count_no_launch(quant, single):
    q_lat, q_rope, c, kr, table, lens = _mla_case(2, 1, [5, 19], seed=3)
    plain, jfn, wrapper = (SINGLE if single else MULTI)[quant]
    if single:
        q_lat, q_rope = q_lat[:, 0], q_rope[:, 0]
    args = [torch.from_numpy(a) for a in
            [q_lat, q_rope, *_pages(c, kr, quant), table, lens]]
    before = wrapper.launches
    got = wrapper(*args)       # the default scale: (R + Dr)^-0.5, as JAX's
    assert wrapper.launches == before
    torch.testing.assert_close(got, plain(*args, sm_scale=(R + DR) ** -0.5),
                               rtol=0, atol=0)
    ref = jfn(*(jnp.asarray(a.numpy()) for a in args), use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_mla_wrappers_refuse_bad_shapes_and_other_devices():
    q_lat, q_rope, c, kr, table, lens = (torch.from_numpy(a) for a in
                                         _mla_case(2, 1, [5, 19], seed=3))
    with pytest.raises(ValueError, match="q_rope"):
        paged_attention_multi_mla(q_lat, q_rope[..., :8], c, kr, table, lens)
    with pytest.raises(ValueError, match="disagree on"):
        paged_attention_multi_mla(q_lat, q_rope, c, kr[:1], table, lens)
    cq, cs = _kv_quant(c)
    kq, ks = _kv_quant(kr)
    with pytest.raises(ValueError, match="scale shapes"):
        paged_attention_multi_mla_quant(q_lat, q_rope, cq, kq, cs[:, :2], ks,
                                        table, lens)
    meta = [x.to("meta") for x in (q_lat, q_rope, c, kr, table, lens)]
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention_multi_mla(*meta)


# -- the model: projections, steps, arena ---------------------------------------------

DIMS = dict(vocab_size=128, embed_dim=64, n_layers=2, mlp_dim=128,
            max_seq_len=256)
VARIANTS = {
    "plain": ({}, False),
    "int8": ({}, True),
    "yarn": ({"rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                               "beta_fast": 32, "beta_slow": 1,
                               "mscale": 1.0, "mscale_all_dim": 0.707,
                               "original_max_position_embeddings": 16}},
             False),
    "q_lora": ({"mla_q_lora_rank": 24}, False),
}
N_PAGES, COLS = 24, 8


def _jax_cfg(**kw):
    return jllama.tiny_mla(**DIMS, dtype=jnp.float32, param_dtype=jnp.float32,
                           **kw)


def _numpy_tree(jcfg, seed: int = 20261016):
    """Seeded numpy parameters in the JAX tree layout (norm weights near
    1 so they matter)."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(jcfg, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.08 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _pair(**kw):
    jcfg = _jax_cfg(**kw)
    tree = _numpy_tree(jcfg)
    cfg = config_from_jax(jcfg, torch.float32)
    return (jllama.LlamaModel(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
            LlamaModel(cfg, device="cpu"),
            params_from_jax(tree, cfg, device="cpu"), tree)


@pytest.mark.parametrize("q_lora", [None, 24], ids=["full_rank", "q_lora"])
def test_mla_project_matches_jax(q_lora):
    jmodel, jparams, model, params, tree = _pair(mla_q_lora_rank=q_lora)
    jcfg = jmodel.cfg
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    pos = rng.integers(0, 256, size=(2, 5)).astype(np.int32)
    cos, sin = jllama._rope_tables(jcfg)[0]
    lp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"])
    ref = jllama._mla_project(jnp.asarray(h), lp, jcfg, cos, sin,
                              jnp.asarray(pos), 2, 5)
    got = model._mla_project(torch.from_numpy(h), params["layers"], 1,
                             torch.from_numpy(pos).long())
    for name, g, r in zip(("q_nope", "q_rope", "c", "kr"), got, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0, err_msg=name)


def _run_both(variant):
    """Chunked prefill of two prompts (padded batch of 2), three greedy
    decode steps, then a 3-token verify step; per-step logits of both
    packages and both arenas."""
    kw, quant = VARIANTS[variant]
    jmodel, jparams, model, params, _ = _pair(**kw)
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
    # a 3-token verify: slot 0 writes all three rows, slot 1 only two
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
    return out, jarena, arena, quant


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_steps_match_jax_logits_and_latent_arena(variant):
    steps, jarena, arena, quant = _run_both(variant)
    for i, (ref, got) in enumerate(steps):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0,
                                   err_msg=f"step {i}")
    want = {"c", "kr"} | ({"c_scale", "kr_scale"} if quant else set())
    assert set(arena) == want == set(jarena)
    assert arena["c"].shape == (2, N_PAGES + 1, T, 64)
    assert arena["kr"].shape == (2, N_PAGES + 1, T, 16)
    for name in want:
        got = arena[name][:, :N_PAGES].numpy()
        ref = np.asarray(jarena[name])
        if name.endswith("scale"):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0,
                                       err_msg=name)
        elif quant:
            assert got.dtype == np.int8
            assert np.abs(got.astype(np.int32) - ref).max() <= 1, name
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_dropped_rows_write_only_the_sink_page(quant):
    _, _, model, params, _ = _pair()
    gen = torch.Generator().manual_seed(1)
    arena = model.init_paged_arena(8, 4, quantize=quant)
    for a in arena.values():       # live contents to protect
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
        changed = (a != before[name]).reshape(2, 9, 4, -1).any(-1).any(0)
        allowed = torch.zeros_like(changed)
        allowed[4, 1] = True          # slot 0's new row
        allowed[2, :3] = True         # the chunk's real rows
        allowed[8] = True             # the sink page
        assert not (changed & ~allowed).any(), name
        assert changed[4, 1] and changed[2, :3].all(), name


# -- quantizer, configs, refusals --------------------------------------------------

def _leaves(tree, prefix=""):
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            yield from _leaves(leaf, f"{prefix}{name}/")
        else:
            yield prefix + name, leaf


@pytest.mark.parametrize("q_lora", [None, 24], ids=["full_rank", "q_lora"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_of_mla_bit_identical_to_jax(bits, q_lora):
    jcfg = _jax_cfg(mla_q_lora_rank=q_lora)
    tree = _numpy_tree(jcfg)
    ref = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, jquant.quantize_params(jcfg, tree, bits=bits))))
    cfg = config_from_jax(jcfg, torch.float32)
    got = dict(_leaves(quantize_params(
        cfg, jax.tree_util.tree_map(torch.from_numpy, tree), bits=bits)))
    assert set(got) == set(ref)
    kind = "q4" if bits == 4 else "q8"
    names = ["w_dkv"] + (["w_qa", "w_qb"] if q_lora else ["wq"])
    for name in names:
        assert f"layers/{name}/{kind}" in got
    assert "layers/w_uk" in got and "layers/w_uv" in got
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_mla_configs_match_the_jax_package():
    assert config_from_jax(jllama.mla_8b(), torch.bfloat16) == mla_8b()
    assert config_from_jax(jllama.tiny_mla(), torch.bfloat16) == tiny_mla()
    assert MODEL_CONFIGS["mla-8b"] is mla_8b
    assert MODEL_CONFIGS["tiny-mla"] is tiny_mla
    cfg = mla_8b()
    assert cfg.is_mla and not tiny_llama().is_mla
    assert cfg.sm_scale == (128 + 64) ** -0.5
    q = jllama.tiny_mla(mla_q_lora_rank=24)
    assert config_from_jax(q, torch.float32).mla_q_lora_rank == 24
    # (512 + 64) bf16 latents a position and layer: 1,152 bytes
    arena = LlamaModel(dataclasses.replace(cfg, n_layers=1),
                       device="cpu").init_paged_arena(1, 16)
    assert {k: tuple(v.shape) for k, v in arena.items()} == \
        {"c": (1, 2, 16, 512), "kr": (1, 2, 16, 64)}
    assert sum(a[0, 0].numel() * a.element_size()
               for a in arena.values()) == 16 * 1152


@pytest.mark.parametrize("jcfg", [
    jllama.deepseek_v2_lite(),
    jllama.tiny_mla(n_experts=4, n_experts_per_tok=2),
    jllama.tiny_mla(name="tiny-mla-prefix", n_experts=4, n_experts_per_tok=2,
                    n_dense_prefix=1)], ids=lambda c: c.name)
def test_moe_and_dense_prefix_mla_configs_are_refused(jcfg):
    with pytest.raises(ValueError, match="does not serve"):
        config_from_jax(jcfg, torch.bfloat16)


def test_forward_and_bad_mla_fields_raise():
    model = LlamaModel(tiny_mla(**DIMS, dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        model.forward({}, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="requires MLA"):
        LlamaModel(tiny_llama(mla_q_lora_rank=8), device="cpu")
