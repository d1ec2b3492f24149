"""MLA's contiguous path in the port against the JAX package, on the CPU in
f32 (``tiny_mla`` at two layers, weights and inputs from numpy seeds):

- ``LlamaModel.forward`` in MLA's direct form (per-head K = [c w_uk, kr],
  V = c w_uv zero-padded to head_dim + rope_dim, flash at that width)
  against the JAX ``forward`` (``use_pallas`` off on the CPU, as the JAX
  package's own tests run it): logits and the final-norm hidden state
  within atol and rtol 1e-5, full-rank q, ``mla_q_lora_rank`` and YaRN;
- ``prefill`` into ``init_cache`` (bf16-layout and int8 latents), then
  ``prefill_chunk_step``, against the JAX model's: the cache's keys,
  shapes and dtypes equal, logits and latent sections within 1e-5 (int8
  rows within one rounding step where the f32 rows sit on a rounding
  edge, the test of ``tests/test_torch_dense_prefill.py``);
- ``verify_step`` (the absorbed form on the contiguous latent cache) with
  one row inactive: the active row's logits and the latents within 1e-5,
  the inactive row's cache untouched;
- the engine's dense-scratch route over int8 latents (the f32 latents'
  route, with ``register_prefix`` on a full pool, is
  ``tests/test_torch_dense_prefill.py``): a prompt no up-front run can
  hold, an n = 2 group and ``register_prefix`` on a full pool give the
  JAX engine's greedy tokens exactly, count the dense route and leak no
  page; ``embed`` within 1e-5 of the JAX engine's;
- step 1 of MLA training against the JAX package's, on one device
  (``make_train_step``) and on an in-process ``seq`` = 2 mesh (the JAX
  ``Trainer`` on ``MeshConfig(data=1, fsdp=4, seq=2)``, ``ring_flash`` on
  and off in the port): the loss and grad norm within rtol 1e-5 and every
  gradient leaf within atol 1e-6 + rtol 1e-4 (f32 products summed in
  other orders over two layers; the gradients of ``tests/test_torch_
  train.py``'s three steps agree to ~1e-7).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.parallel.mesh import MeshConfig as JMeshConfig
from k8s_runpod_kubelet_tpu.parallel.mesh import make_mesh as jmake_mesh
from k8s_runpod_kubelet_tpu.workloads import train as jtrain
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.train import (TrainConfig,
                                                          Trainer, _leaves,
                                                          loss_and_grads)

TIMEOUT = 120
DIMS = dict(vocab_size=128, embed_dim=64, n_layers=2, mlp_dim=128,
            max_seq_len=256)
VARIANTS = {
    "full_rank": {},
    "q_lora": {"mla_q_lora_rank": 24},
    "yarn": {"rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                              "beta_fast": 32, "beta_slow": 1,
                              "mscale": 1.0, "mscale_all_dim": 0.707,
                              "original_max_position_embeddings": 16}},
}
T = 8


def _jax_cfg(**kw):
    return jllama.tiny_mla(**DIMS, dtype=jnp.float32, param_dtype=jnp.float32,
                           **kw)


def _numpy_tree(jcfg, seed: int = 20261018):
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


def _pair(variant: str, master: bool = False):
    jcfg = _jax_cfg(**VARIANTS[variant])
    tree = _numpy_tree(jcfg)
    cfg = config_from_jax(jcfg, torch.float32)
    return (jllama.LlamaModel(jcfg), jax.tree_util.tree_map(jnp.asarray, tree),
            LlamaModel(cfg, device="cpu"),
            params_from_jax(tree, cfg, device="cpu", master=master))


@pytest.fixture(scope="module")
def pair():
    return _pair("full_rank")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5,
                               err_msg=what)


def _close_sections(cache, jcache, names):
    for name in names:
        a, b = _np(cache[name]), _np(jcache[name])
        assert a.shape == b.shape, name
        if a.dtype == np.int8:
            # a row's f32 values agree to ~1e-7: a value on a rounding
            # edge may round either way, one step
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
        else:
            _close(a, b, name)


# -- forward ----------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_and_hidden_match_jax(variant):
    jmodel, jparams, model, params = _pair(variant, master=True)
    tokens = np.random.default_rng(1).integers(
        0, DIMS["vocab_size"], (2, 24)).astype(np.int32)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    logits = model.forward(params, tt)
    assert logits.shape == (2, 24, DIMS["vocab_size"])
    _close(logits, jmodel.forward(jparams, jt), "logits")
    hidden = model.forward(params, tt, return_hidden=True)
    assert hidden.shape == (2, 24, DIMS["embed_dim"])
    _close(hidden, jmodel.forward(jparams, jt, return_hidden=True),
           "hidden")


def test_forward_with_positions_and_without_remat_matches_jax(pair):
    jmodel, jparams, model, params = pair
    tokens = np.random.default_rng(2).integers(
        0, DIMS["vocab_size"], (2, 16)).astype(np.int32)
    pos = (np.arange(16)[None, :] * 2 + np.arange(2)[:, None]).astype(
        np.int32)
    want = jmodel.forward(jparams, jnp.asarray(tokens), jnp.asarray(pos))
    flat = LlamaModel(dataclasses.replace(model.cfg, remat_policy="none"),
                      device="cpu")
    for m in (model, flat):
        _close(m.forward(params, torch.from_numpy(tokens),
                         torch.from_numpy(pos)), want)


# -- the contiguous latent cache ----------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_prefill_and_chunk_step_match_jax(pair, quantize):
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(1, 128, 40)]
    head, rest = prompt[:24], prompt[24:]
    jcache = jmodel.init_cache(1, 64, quantize=quantize)
    cache = model.init_cache(1, 64, quantize=quantize)
    assert set(cache) == set(jcache)
    assert {"c", "kr", "index"} <= set(cache)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(jcache[name].dtype), name
    jl, jcache = jmodel.prefill(jparams, jnp.asarray([head], jnp.int32),
                                jcache)
    tl, cache = model.prefill(params, torch.tensor([head]), cache)
    _close(tl, jl, "prefill logits")
    names = [n for n in cache if n != "index"]
    _close_sections(cache, jcache, names)
    assert _np(cache["index"]).tolist() == [24]
    jl, jcache = jmodel.prefill_chunk_step(
        jparams, jnp.asarray([rest], jnp.int32), jcache,
        jnp.asarray([len(rest)], jnp.int32))
    tl, cache = model.prefill_chunk_step(params, torch.tensor([rest]), cache,
                                         torch.tensor([len(rest)]))
    _close(tl, jl, "chunk logits")
    _close_sections(cache, jcache, names)
    assert _np(cache["index"]).tolist() == _np(jcache["index"]).tolist() \
        == [40]


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_verify_step_writes_active_rows_only(pair, quantize):
    """Two rows prefilled to different lengths (the second padded past its
    true length), then a K = 3 verify with the second row inactive."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 128, (2, 20)).astype(np.int32)
    true_len = np.array([20, 13], np.int32)
    jcache = jmodel.init_cache(2, 48, quantize=quantize)
    cache = model.init_cache(2, 48, quantize=quantize)
    jl, jcache = jmodel.prefill(jparams, jnp.asarray(toks), jcache,
                                jnp.asarray(true_len))
    tl, cache = model.prefill(params, torch.from_numpy(toks), cache,
                              torch.from_numpy(true_len))
    _close(tl, jl)
    draft = rng.integers(1, 128, (2, 3)).astype(np.int32)
    active = np.array([True, False])
    jl, jcache = jmodel.verify_step(jparams, jnp.asarray(draft), jcache,
                                    jnp.asarray(active))
    before = {n: t.clone() for n, t in cache.items()}
    tl, cache = model.verify_step(params, torch.from_numpy(draft), cache,
                                  torch.from_numpy(active))
    assert tl.shape == (2, 3, DIMS["vocab_size"])
    _close(tl[0], np.asarray(jl)[0], "active row's logits")
    names = [n for n in cache if n != "index"]
    _close_sections(cache, jcache, names)
    for name in names:
        assert torch.equal(cache[name][:, 1], before[name][:, 1]), name
    assert not torch.equal(cache["c"][:, 0], before["c"][:, 0])
    # verify does not advance the index
    assert torch.equal(cache["index"], before["index"])


def test_verify_positions_past_the_cache_raise(pair):
    _, _, model, params = pair
    cache = model.init_cache(1, 8)
    cache["index"].fill_(6)
    with pytest.raises(ValueError, match="past the cache length"):
        model.verify_step(params, torch.ones((1, 3), dtype=torch.int32),
                          cache)


# -- the engine's dense-scratch route, int8 latents ---------------------------------

PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(1, 128, n)]
           for s, n in ((21, 58), (22, 58), (23, 40))]
PREFIX = [int(t) for t in np.random.default_rng(24).integers(1, 128, 20)]
GROUP = [int(t) for t in np.random.default_rng(25).integers(1, 128, 30)]
EMBED = [int(t) for t in np.random.default_rng(26).integers(1, 128, 27)]


def _sc(cls):
    # 2 slots of 8 pages; the pool's minimum, 16 pages; int8 latents
    return cls(slots=2, max_prefill_len=32, cache_len=64, max_new_tokens=6,
               kv_page_tokens=T, kv_pool_pages=16, quantize_kv_int8=True)


def _wait(cond, what: str):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _traffic(engine) -> dict:
    """Two 58-token prompts whose runs take the whole pool, the engine
    thread held at the first one's first token so the second stays
    prefilled and unbound; a 40-token prompt no up-front run can hold and
    a prefix registered on that full pool; then, the engine running, an
    n = 2 greedy group over one prompt and an embedding."""
    entered, gate = threading.Event(), threading.Event()

    def hold(_tok):
        if not entered.is_set():
            entered.set()
            gate.wait(TIMEOUT)

    f1 = engine.submit(PROMPTS[0], on_token=hold)
    _wait(entered.is_set, "the first request was never admitted")
    f2 = engine.submit(PROMPTS[1])
    _wait(lambda: engine._ready.qsize() == 1, "the second never prefilled")
    f3 = engine.submit(PROMPTS[2])
    _wait(lambda: engine._ready.qsize() == 2, "the third never prefilled")
    try:
        engine.register_prefix(PREFIX)
        registered = engine.prefix_cache_stats()["registered"]
    finally:
        gate.set()
    toks = [f.result(timeout=TIMEOUT)["tokens"] for f in (f1, f2, f3)]
    group = [f.result(timeout=TIMEOUT)["tokens"]
             for f in engine.submit_group(GROUP, 2)]
    return {"tokens": toks, "registered": registered, "group": group,
            "embed": np.asarray(engine.embed(EMBED), np.float32)}


@pytest.fixture(scope="module")
def jax_outcome():
    jcfg = _jax_cfg()
    jparams = jax.tree_util.tree_map(jnp.asarray, _numpy_tree(jcfg))
    jeng = JaxServingEngine(jcfg, jparams, _sc(JaxServingConfig))
    native = jeng._prefill_paged_native
    seen = {"native_none": 0}

    def spy_native(*a, **k):
        out = native(*a, **k)
        seen["native_none"] += out is None
        return out

    jeng._prefill_paged_native = spy_native
    jeng.start()
    try:
        out = _traffic(jeng)
    finally:
        jeng.stop()
    assert "c" in jeng._kv_store.arena
    return out, seen


@pytest.fixture(scope="module")
def port_outcome(pair):
    _, _, model, params = pair
    eng = ServingEngine(model.cfg, params, _sc(ServingConfig),
                        device="cpu").start()
    try:
        out = _traffic(eng)
        eng.drain()
        _wait(lambda: eng.drained, "the engine did not drain")
        store = eng._kv_store
        nodes = list(store.trie._nodes.values())
        out["leak"] = (store.pool.free_count + len(nodes)
                       - store.pool.n_pages,
                       [store.pool.refcount(n.page) for n in nodes])
        out["counters"] = dict(eng.counters)
        out["arena"] = sorted(store.arena)
    finally:
        eng.stop()
    return out


def test_jax_mla_engine_takes_its_fallback(jax_outcome):
    """The reference's own route on this traffic: the native prefill of
    the third prompt and of the prefix finds no up-front run."""
    _, seen = jax_outcome
    assert seen["native_none"] == 2


def test_full_pool_tokens_match_the_jax_engine(jax_outcome, port_outcome):
    want, _ = jax_outcome
    assert port_outcome["arena"] == ["c", "c_scale", "kr", "kr_scale"]
    assert port_outcome["tokens"] == want["tokens"]
    assert port_outcome["registered"] == want["registered"] == 1
    counters = port_outcome["counters"]
    # the third prompt and the prefix on the full pool, then the group
    assert counters["dense_prefills"] == 3
    assert counters["admission_rejected"] == 0


def test_group_of_two_matches_the_jax_engine(jax_outcome, port_outcome):
    want, _ = jax_outcome
    assert port_outcome["group"] == want["group"]
    assert port_outcome["group"][0] == port_outcome["group"][1]
    assert len(port_outcome["group"][0]) == 6


def test_embed_matches_the_jax_engine(jax_outcome, port_outcome):
    want, _ = jax_outcome
    assert port_outcome["counters"]["embeds"] == 1
    np.testing.assert_allclose(port_outcome["embed"], want["embed"],
                               atol=1e-5, rtol=1e-5)


def test_dense_route_leaks_no_page(port_outcome):
    spare, refcounts = port_outcome["leak"]
    assert spare == 0
    assert all(r == 1 for r in refcounts)


# -- training -----------------------------------------------------------------------

B, S = 4, 16


def _batch():
    return np.random.default_rng(7).integers(
        0, DIMS["vocab_size"], (B, S + 1)).astype(np.int32)


def _sorted_leaves(tree):
    return [np.asarray(x) for _, x in sorted(
        jax.tree_util.tree_flatten_with_path(tree)[0],
        key=lambda kv: [str(k.key) for k in kv[0]])]


def _jax_grads(jmodel, jparams, batch):
    def loss(p):
        logits = jmodel.forward(p, batch[:, :-1])
        return jtrain.cross_entropy_loss(logits, batch[:, 1:])
    return jax.jit(jax.value_and_grad(loss))(jparams)


@pytest.fixture(scope="module")
def jax_step1():
    """Step 1 of the JAX package on one device and on the seq = 2 mesh:
    (loss, grad norm, gradient leaves) of each."""
    jcfg = _jax_cfg(ring_flash=True)
    tree = _numpy_tree(jcfg)
    batch = jnp.asarray(_batch())
    jtc = jtrain.TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=3,
                             batch_size=B, seq_len=S)
    out = {}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jmodel = jllama.LlamaModel(jcfg)
    jopt = jtrain.make_optimizer(jtc)
    step = jtrain.make_train_step(jmodel, jopt, donate=False)
    _, _, m = step(jparams, jopt.init(jparams), batch)
    _, grads = _jax_grads(jmodel, jparams, batch)
    out["one_device"] = (float(m["loss"]), float(m["grad_norm"]),
                         _sorted_leaves(grads))
    mesh = jmake_mesh(JMeshConfig(data=1, fsdp=4, seq=2))
    trainer = jtrain.Trainer(jcfg, jtc, mesh=mesh, initial_params=tree)
    _, grads = _jax_grads(jllama.LlamaModel(jcfg, mesh), trainer.params,
                          batch)
    _, _, m = trainer.step_fn(trainer.params, trainer.opt_state, batch)
    out["seq2"] = (float(m["loss"]), float(m["grad_norm"]),
                   _sorted_leaves(grads))
    return tree, out


@pytest.mark.parametrize("mesh,ring_flash", [
    (None, True), ("seq2", True), ("seq2", False)],
    ids=["one_device", "seq2_ring_flash", "seq2_plain_ring"])
def test_train_step1_matches_jax(jax_step1, mesh, ring_flash):
    tree, out = jax_step1
    jloss, jnorm, jgrads = out[mesh or "one_device"]
    cfg = dataclasses.replace(
        config_from_jax(_jax_cfg(ring_flash=True), torch.float32),
        ring_flash=ring_flash)
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=3,
                     batch_size=B, seq_len=S)
    trainer = Trainer(cfg, tc, device="cpu",
                      initial_params=params_from_jax(tree, cfg, "cpu",
                                                     master=True),
                      mesh=make_mesh(MeshConfig(seq=2)) if mesh else None)
    batch = torch.from_numpy(_batch())
    loss, grads = loss_and_grads(trainer.model, trainer.params, batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert len(grads) == len(jgrads) == len(_leaves(trainer.params))
    for g, want in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-6, rtol=1e-4)
    m = trainer.step_fn(trainer.params, trainer.opt_state, batch)
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=1e-5)
