"""The port's sparse-MoE pieces against the JAX package's, on the CPU.

Inputs are made from seeds with numpy and handed to both packages:

- ``int4_expert_matmul``'s plain version against JAX ``int4_expert_matmul``
  (its f32 fallback) at 1e-5, and against JAX ``int4_matmul`` in interpret
  mode (the Pallas kernel) per expert at 2e-5 (f32 sums in another
  order); rows at or past ``counts`` come back as zeros;
- ``route_top_k`` with ``norm_topk`` both ways: the same expert ids,
  weights and probabilities within 1e-6 (the seeds keep every top-2/3
  probability gap above 1e-3, so an f32 rounding cannot reorder the picks;
  ``torch.topk`` and ``jax.lax.top_k`` may break exact ties differently);
- ``moe_mlp`` against JAX ``moe_mlp`` for raw f32, int8 and int4 expert
  leaves, at the serving factor X/k (no drop) and at 1.25, where drops
  happen: output within 1e-5, the load-balance and z losses within 1e-6;
- the contiguous ``forward`` of f32 ``tiny_moe`` against the JAX forward
  at the training capacity (drops included) within 1e-4;
- ``init_quantized_params`` bit-equal to ``quantize_params(init_params)``
  at ``tiny-moe`` for 4 and 8 bits, and ``quantize_params`` keeps leaves
  already quantized;
- ``params_from_jax`` on a JAX ``tiny_moe`` tree, raw and quantized; the
  DeepSeek-MoE fields carried by ``config_from_jax``;
- Mixtral-8x7B's parameter count from ``param_shapes`` (no allocation)
  equal to the JAX config's, 46.70 B;
- Mixtral's HF names round-tripped against JAX ``models/convert.py``;
- ``Trainer`` builds over an MoE config and steps.
"""

import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import convert as jconvert
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import moe as jmoe
from k8s_runpod_kubelet_tpu.models import quant as jquant
from k8s_runpod_kubelet_tpu.ops import int4_matmul as jint4
from k8s_runpod_kubelet_tpu_torch.models import (MODEL_CONFIGS, LlamaModel,
                                                 init_params)
from k8s_runpod_kubelet_tpu_torch.models import llama as tllama
from k8s_runpod_kubelet_tpu_torch.models import moe as tmoe
from k8s_runpod_kubelet_tpu_torch.models.convert import (load_hf,
                                                         to_hf_state_dict)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.quant import (
    init_quantized_params, quantize_params)
from k8s_runpod_kubelet_tpu_torch.ops import int4_expert_matmul
from k8s_runpod_kubelet_tpu_torch.workloads.train import (TrainConfig,
                                                          Trainer)

JCFG = jllama.tiny_moe(vocab_size=128, embed_dim=128, n_layers=2,
                       n_heads=4, n_kv_heads=2, mlp_dim=256,
                       max_seq_len=128, dtype=jnp.float32,
                       param_dtype=jnp.float32)


def _experts_int4(rng, x, kin, out):
    """JAX-quantized int4 experts (X, in/2, out) and (X, g, 1, out)."""
    w = (0.05 * rng.normal(size=(x, kin, out))).astype(np.float32)
    leaf = jquant._quantize_leaf_int4(w)
    return np.asarray(leaf["q4"]), np.asarray(leaf["scale"])


def test_int4_expert_matmul_plain_matches_jax():
    rng = np.random.default_rng(20261017)
    q4, scale = _experts_int4(rng, 3, 256, 128)
    assert q4.shape == (3, 128, 128) and scale.shape == (3, 2, 1, 128)
    h = rng.normal(size=(3, 5, 256)).astype(np.float32)
    ref = np.asarray(jint4.int4_expert_matmul(
        jnp.asarray(h), jnp.asarray(q4), jnp.asarray(scale)))
    got = int4_expert_matmul(torch.from_numpy(h), torch.from_numpy(q4),
                             torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (3, 5, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    for x in range(3):   # the Pallas kernel in interpret mode, per expert
        pallas = np.asarray(jint4.int4_matmul(
            jnp.asarray(h[x]), jnp.asarray(q4[x]), jnp.asarray(scale[x]),
            interpret=True))
        np.testing.assert_allclose(got[x].numpy(), pallas, rtol=2e-5,
                                   atol=2e-5)
    # counts: a JAX buffer's rows past an expert's count are zero, and so
    # are its results; the port zeroes them whatever h holds there
    counts = np.array([5, 2, 0], np.int32)
    past = np.arange(5)[None, :] >= counts[:, None]
    zeroed = np.where(past[..., None], 0.0, h).astype(np.float32)
    ref = np.asarray(jint4.int4_expert_matmul(
        jnp.asarray(zeroed), jnp.asarray(q4), jnp.asarray(scale)))
    got = int4_expert_matmul(torch.from_numpy(h), torch.from_numpy(q4),
                             torch.from_numpy(scale),
                             torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert not got.numpy()[past].any()


def test_int4_expert_matmul_rejects_mismatched_shapes():
    q4 = torch.zeros((2, 64, 32), dtype=torch.uint8)
    scale = torch.ones((2, 1, 1, 32))
    with pytest.raises(ValueError, match="experts"):
        int4_expert_matmul(torch.zeros((3, 4, 128)), q4, scale)
    with pytest.raises(ValueError, match="in-elements"):
        int4_expert_matmul(torch.zeros((2, 4, 64)), q4, scale)
    with pytest.raises(ValueError, match="counts"):
        int4_expert_matmul(torch.zeros((2, 4, 128)), q4, scale,
                           torch.zeros(3, dtype=torch.int32))


def _router_logits(seed, g, x):
    """Seeded f32 router logits whose top-(k+1) probabilities are at least
    1e-3 apart for k = 2, so both sides pick the same experts."""
    logits = np.random.default_rng(seed).normal(size=(g, x)).astype(
        np.float32)
    p = np.sort(jax.nn.softmax(jnp.asarray(logits), axis=-1), axis=-1)
    assert np.diff(p[:, -3:], axis=-1).min() > 1e-3
    return logits


@pytest.mark.parametrize("norm_topk", [True, False])
def test_route_top_k_matches_jax(norm_topk):
    logits = _router_logits(0, 16, 8)
    jw, ji, jp = jmoe.route_top_k(jnp.asarray(logits), 2, norm_topk)
    tw, ti, tp = tmoe.route_top_k(torch.from_numpy(logits), 2, norm_topk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)
    assert np.allclose(tw.sum(-1).numpy(), 1.0) == norm_topk


def _expert_leaves(rng, kind, x, e, m):
    """Raw f32 expert leaves, or the JAX quantizer's int8 / int4 ones, as
    numpy (for JAX) and torch (for the port)."""
    raw = {name: (0.05 * rng.normal(size=shape)).astype(np.float32)
           for name, shape in (("we_gate", (x, e, m)), ("we_up", (x, e, m)),
                               ("we_down", (x, m, e)))}
    if kind == "raw":
        return raw, {n: torch.from_numpy(w) for n, w in raw.items()}
    quant = jquant._quantize_leaf if kind == "int8" \
        else jquant._quantize_leaf_int4
    jx = {n: {k: np.asarray(v) for k, v in quant(w).items()}
          for n, w in raw.items()}
    return jx, {n: {k: torch.from_numpy(np.array(v)) for k, v in w.items()}
                for n, w in jx.items()}


@pytest.mark.parametrize("factor", [2.0, 1.25], ids=["serving_x_over_k",
                                                     "training_drops"])
@pytest.mark.parametrize("kind", ["raw", "int8", "int4"])
def test_moe_mlp_matches_jax(kind, factor):
    x_experts, k, e, m = 4, 2, 128, 256
    rng = np.random.default_rng(11)
    h = rng.normal(size=(2, 12, e)).astype(np.float32)
    # a router skewed towards expert 0, so that 1.25 drops assignments
    router = (0.3 * rng.normal(size=(e, x_experts))).astype(np.float32)
    router[:, 0] += 0.2 * h.reshape(-1, e).mean(0) / np.abs(
        h.reshape(-1, e).mean(0)).max()
    jw, tw = _expert_leaves(rng, kind, x_experts, e, m)
    names = ("we_gate", "we_up", "we_down")
    jy, jaux, jz = jmoe.moe_mlp(
        jnp.asarray(h), jnp.asarray(router),
        *(jax.tree_util.tree_map(jnp.asarray, jw[n]) for n in names),
        n_experts_per_tok=k, capacity_factor=factor,
        activation=jax.nn.silu, dtype=jnp.float32)
    ty, taux, tz = tmoe.moe_mlp(
        torch.from_numpy(h), torch.from_numpy(router),
        *(tw[n] for n in names), n_experts_per_tok=k,
        capacity_factor=factor, dtype=torch.float32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(tz.item(), float(jz), rtol=1e-6)
    # whether this factor drops: the busiest expert's assignments vs cap
    g = h.shape[0] * h.shape[1]
    _, ids, _ = tmoe.route_top_k(torch.from_numpy(h).reshape(g, e)
                                 @ torch.from_numpy(router), k)
    busiest = int(torch.bincount(ids.flatten()).max())
    cap = tmoe.moe_capacity(g, x_experts, k, factor)
    assert (busiest > cap) == (factor == 1.25), (busiest, cap)
    _, aux, z = tmoe.moe_mlp(torch.from_numpy(h), torch.from_numpy(router),
                             *(tw[n] for n in names), n_experts_per_tok=k,
                             capacity_factor=factor, dtype=torch.float32,
                             with_losses=False)
    assert aux is None and z is None


def _jax_tree(cfg, seed=7):
    """Seeded numpy parameters in the JAX layout (norms near 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(cfg, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        scale = 0.3 if str(path[-1].key) == "router" else 0.05
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def test_contiguous_forward_matches_jax_with_drops():
    """The training capacity (1.25) on both sides: the same assignments
    drop, so the logits agree; ``train=False`` routes every token."""
    tree = _jax_tree(JCFG)
    cfg = config_from_jax(JCFG, torch.float32)
    assert (cfg.n_experts, cfg.n_experts_per_tok, cfg.capacity_factor) == \
        (4, 2, 1.25)
    params = params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(2).integers(1, 128, (2, 24)).astype(np.int32)
    ref = np.asarray(jllama.LlamaModel(JCFG).forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(toks)))
    model = LlamaModel(cfg, device="cpu")
    got = model.forward(params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # serving capacity: the JAX model's train=False routing
    no_drop = dataclasses.replace(JCFG, capacity_factor=2.0)
    ref = np.asarray(jllama.LlamaModel(no_drop).forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(toks)))
    got = model.forward(params, torch.from_numpy(toks), train=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bits", [4, 8])
def test_streamed_quantized_init_is_bit_equal(bits):
    cfg = MODEL_CONFIGS["tiny-moe"](vocab_size=256, embed_dim=128,
                                    mlp_dim=256)
    ref = quantize_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(5), "cpu"), bits)
    got = init_quantized_params(cfg, torch.Generator().manual_seed(5), bits,
                                "cpu")

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            return all(same(a[k], b[k]) for k in a)
        return a.dtype == b.dtype and torch.equal(a, b)

    assert same(ref, got)
    kind = "q4" if bits == 4 else "q8"
    lp = got["layers"]
    assert lp["router"].dtype == torch.float32
    assert lp["we_gate"][kind].shape[:2] == (2, 4)
    want = (2, 4, 2, 1, 128) if bits == 4 else (2, 4, 1, 128)
    assert lp["we_down"]["scale"].shape == want
    # an already quantized tree goes through the engine's quantizer as it
    # is; the other width is refused
    again = quantize_params(cfg, got, bits)
    assert again["layers"]["we_up"] is lp["we_up"]
    with pytest.raises(ValueError, match="already quantized"):
        quantize_params(cfg, got, 12 - bits)


@pytest.mark.parametrize("bits", [0, 4, 8])
def test_params_from_jax_carries_moe_trees(bits):
    tree = _jax_tree(JCFG)
    if bits:
        tree = jax.tree_util.tree_map(
            np.asarray, jquant.quantize_params(JCFG, tree, bits=bits))
    cfg = config_from_jax(JCFG, torch.bfloat16)
    params = params_from_jax(tree, cfg, device="cpu")
    lp, jlp = params["layers"], tree["layers"]
    assert set(lp) == set(jlp)
    assert lp["router"].dtype == torch.float32     # routes in f32
    np.testing.assert_array_equal(lp["router"].numpy(), jlp["router"])
    if bits:
        kind = "q4" if bits == 4 else "q8"
        for name in ("we_gate", "we_up", "we_down"):
            np.testing.assert_array_equal(lp[name][kind].numpy(),
                                          jlp[name][kind])
            np.testing.assert_array_equal(lp[name]["scale"].numpy(),
                                          jlp[name]["scale"])
    else:
        assert lp["we_down"].dtype == torch.bfloat16
        assert lp["we_down"].shape == (2, 4, 256, 128)


@pytest.mark.parametrize("field,value", [
    ("n_shared_experts", 2),
    ("router_sigmoid_bias", dict(router_sigmoid_bias=True, router_n_group=2,
                                 router_topk_group=1)),
    ("n_dense_prefix", dict(n_dense_prefix=1, mla_latent_dim=32,
                            dense_prefix_mlp_dim=96))])
def test_deepseek_moe_fields_are_refused_by_name(field, value):
    """DeepSeek-MoE's fields on this MoE config: once refused by name, now
    each carried by ``config_from_jax`` (the name kept from then) (a dense prefix needs MLA, V3 routing
    its groups, as the JAX config checks)."""
    kw = value if isinstance(value, dict) else {field: value}
    jcfg = dataclasses.replace(JCFG, **kw)
    cfg = config_from_jax(jcfg, torch.float32)
    for f in kw:
        assert getattr(cfg, f) == getattr(jcfg, f) == kw[f], f


def test_mixtral_parameter_count_from_shapes():
    cfg = MODEL_CONFIGS["mixtral-8x7b"]()
    shapes = tllama.param_shapes(cfg)
    count = sum(math.prod(s) for s in shapes["layers"].values()) + sum(
        math.prod(s) for n, s in shapes.items() if n != "layers")
    assert count == jllama.mixtral_8x7b().param_count
    assert round(count / 1e9, 2) == 46.70
    experts = sum(math.prod(shapes["layers"][n])
                  for n in ("we_gate", "we_up", "we_down"))
    assert round(experts / 1e9, 2) == 45.10
    assert shapes["layers"]["router"] == (32, 4096, 8)
    assert cfg == config_from_jax(jllama.mixtral_8x7b(), torch.bfloat16)


def test_mixtral_hf_names_round_trip_against_jax():
    tree = _jax_tree(JCFG)
    cfg = config_from_jax(JCFG, torch.float32)
    sd = jconvert.to_hf_state_dict(JCFG, tree)
    assert "model.layers.1.block_sparse_moe.experts.3.w2.weight" in sd
    got = load_hf(cfg, {k: np.asarray(v) for k, v in sd.items()},
                  device="cpu")
    want = params_from_jax(tree, cfg, device="cpu")
    for name in want["layers"]:
        assert torch.equal(got["layers"][name], want["layers"][name]), name
    assert torch.equal(got["lm_head"], want["lm_head"])
    # the port's export read back by JAX gives the JAX tree
    back = jconvert.from_hf_state_dict(
        JCFG, {k: v.numpy() for k, v in to_hf_state_dict(cfg, got).items()})
    for name, leaf in tree["layers"].items():
        np.testing.assert_array_equal(np.asarray(back["layers"][name]),
                                      leaf, err_msg=name)
    # DeepSeek-MoE's experts load into a DeepSeek config; into this
    # Mixtral one they are refused by name as a config mismatch
    bad = dict(sd)
    bad["model.layers.0.mlp.experts.0.gate_proj.weight"] = np.zeros((1, 1))
    with pytest.raises(ValueError, match="DeepSeek-MoE"):
        load_hf(cfg, bad, device="cpu")


def test_trainer_refuses_moe_configs():
    """No longer a refusal: the trainer builds over an MoE config and its
    step reports the router's aux loss (the parity with the JAX trainer is
    ``test_torch_moe_train.py``'s)."""
    cfg = MODEL_CONFIGS["tiny-moe"](vocab_size=64, embed_dim=64, mlp_dim=64)
    tr = Trainer(cfg, TrainConfig(batch_size=1, seq_len=8, warmup_steps=1),
                 device="cpu")
    tokens = torch.randint(0, 64, (1, 9),
                           generator=torch.Generator().manual_seed(0))
    m = tr.step_fn(tr.params, tr.opt_state, tokens)
    assert math.isfinite(float(m["loss"])) and float(m["aux_loss"]) > 0
