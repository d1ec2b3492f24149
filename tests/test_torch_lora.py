"""The port's LoRA module (``models/lora.py``) against the JAX package's,
on the CPU:

- ``merge_lora``, ``lora_mask``, ``lora_param_count`` and
  ``extract_adapter`` on the same numpy inputs (a JAX ``apply_lora`` tree
  with B redrawn non-zero), f32 leaves within 1e-6;
- ``apply_lora``: shapes, B = 0 (the wrapped forward equals the base's
  exactly), A's fan-in statistics (the draws of ``jax.random`` and
  ``torch`` differ, so the distribution is tested, not the values), and
  its refusals;
- ``_mm``'s LoRA leaf: the wrapped forward against the JAX forward of the
  same wrapped tree (1e-4) and against the forward of the merged tree,
  and gradients reaching A and B only;
- the ``.npz`` file: one written by the JAX ``save_adapter`` loads in the
  port's ``load_adapter`` (f32, and bf16 stored as raw bits) and the
  reverse, and ``adapter_from_jax`` takes either form.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import LoraConfig as JLoraConfig
from k8s_runpod_kubelet_tpu.models import apply_lora as japply_lora
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import lora as jlora
from k8s_runpod_kubelet_tpu_torch.models import (LlamaModel, LoraConfig,
                                                 apply_lora, extract_adapter,
                                                 init_params, is_lora,
                                                 load_adapter, lora_mask,
                                                 lora_param_count,
                                                 merge_lora, save_adapter,
                                                 tiny_llama, tiny_moe)
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (adapter_from_jax,
                                                          config_from_jax,
                                                          params_from_jax)

TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=128,
                         max_seq_len=128, dtype=jnp.float32,
                         param_dtype=jnp.float32)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_lora_tree():
    """A JAX LoRA tree over all seven targets, B redrawn non-zero (zero B
    would make every check vacuous), as numpy."""
    params = jax_init_params(JCFG, jax.random.PRNGKey(3))
    lc = JLoraConfig(rank=4, alpha=8.0, targets=TARGETS)
    wrapped = japply_lora(JCFG, params, lc, jax.random.PRNGKey(5))
    layers = dict(wrapped["layers"])
    key = jax.random.PRNGKey(7)
    for t in TARGETS:
        key, sub = jax.random.split(key)
        w = dict(layers[t])
        w["lora_b"] = jax.random.normal(sub, w["lora_b"].shape) * 0.05
        layers[t] = w
    return _numpy(dict(wrapped, layers=layers))


def _port_tree(jtree):
    """The port's wrapped tree of the same values: the base through
    ``params_from_jax``, the adapters through ``adapter_from_jax``."""
    cfg = config_from_jax(JCFG, torch.float32)
    base = {k: v for k, v in jtree.items() if k != "layers"}
    base["layers"] = {k: (v["w"] if isinstance(v, dict) else v)
                      for k, v in jtree["layers"].items()}
    params = params_from_jax(base, cfg, device="cpu")
    ad = adapter_from_jax(jtree, device="cpu")
    for t, a in ad.items():
        params["layers"][t] = {"w": params["layers"][t],
                               "lora_a": a["a"], "lora_b": a["b"],
                               "scale": a["scale"]}
    return cfg, params


def test_merge_mask_count_and_extract_match_jax(jax_lora_tree):
    cfg, params = _port_tree(jax_lora_tree)
    jtree = jax.tree_util.tree_map(jnp.asarray, jax_lora_tree)
    merged_j = _numpy(jlora.merge_lora(jtree))
    merged = merge_lora(params)
    for name, leaf in merged["layers"].items():
        assert not is_lora(leaf)
        np.testing.assert_allclose(leaf.numpy(), merged_j["layers"][name],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # the merge changed every target, and nothing else
    for name in TARGETS:
        assert not np.allclose(merged_j["layers"][name],
                               jax_lora_tree["layers"][name]["w"])
    mask_j = jax.tree_util.tree_map(bool, jlora.lora_mask(jtree))
    assert lora_mask(params) == mask_j
    assert lora_param_count(params) == jlora.lora_param_count(jtree) > 0
    ext, ext_j = extract_adapter(params), _numpy(jlora.extract_adapter(jtree))
    assert set(ext) == set(ext_j) == set(TARGETS)
    for t in TARGETS:
        for k in ("a", "b", "scale"):
            np.testing.assert_array_equal(ext[t][k].numpy(), ext_j[t][k])
    with pytest.raises(ValueError, match="no LoRA adapters"):
        extract_adapter(merged)


def test_merge_never_upcasts_a_bf16_base():
    cfg = tiny_llama(vocab_size=64, embed_dim=32, n_layers=2, mlp_dim=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wrapped = apply_lora(cfg, params, LoraConfig(rank=2, targets=("wq",)),
                         torch.Generator().manual_seed(1), "cpu")
    wrapped["layers"]["wq"]["lora_b"].normal_()
    merged = merge_lora(wrapped)["layers"]["wq"]
    w = wrapped["layers"]["wq"]
    delta = torch.einsum("lir,lro->lio", w["lora_a"].float(),
                         w["lora_b"].float()) * w["scale"][:, None, None]
    assert merged.dtype == torch.bfloat16
    assert torch.equal(merged, w["w"] + delta.to(torch.bfloat16))


def test_apply_lora_shapes_identity_and_fan_in():
    cfg = tiny_llama(vocab_size=128, embed_dim=256, n_layers=2, n_heads=4,
                     n_kv_heads=2, mlp_dim=512, max_seq_len=64,
                     dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lc = LoraConfig(rank=8, alpha=16.0, targets=TARGETS)
    wrapped = apply_lora(cfg, params, lc, torch.Generator().manual_seed(1),
                         "cpu")
    for t in TARGETS:
        w = wrapped["layers"][t]
        base = params["layers"][t]
        assert w["w"] is base
        assert w["lora_a"].shape == (2, base.shape[1], 8)
        assert w["lora_b"].shape == (2, 8, base.shape[2])
        assert not w["lora_b"].any()
        assert torch.equal(w["scale"], torch.full((2,), 2.0))
        # A ~ N(0, 1/d_in): scaled by sqrt(d_in) it is a standard normal;
        # at least 4096 draws a leaf put the mean and std within 4 sigma
        z = w["lora_a"].double() * math.sqrt(base.shape[1])
        n = z.numel()
        assert n >= 4096
        assert abs(z.mean().item()) < 4 / math.sqrt(n)
        assert abs(z.std().item() - 1.0) < 4 / math.sqrt(2 * n)
    model = LlamaModel(cfg, device="cpu")
    toks = torch.randint(0, 128, (2, 16), generator=torch.Generator()
                         .manual_seed(2))
    assert torch.equal(model.forward(wrapped, toks, train=False),
                       model.forward(params, toks, train=False))
    assert lora_param_count(wrapped) == sum(
        w["lora_a"].numel() + w["lora_b"].numel()
        for w in wrapped["layers"].values() if is_lora(w))


def test_apply_lora_refusals():
    cfg = tiny_llama(vocab_size=64, embed_dim=32, n_layers=1, mlp_dim=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="no targets"):
        apply_lora(cfg, params, LoraConfig(targets=()), gen, "cpu")
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        apply_lora(cfg, params, LoraConfig(targets=("w_dkv",)), gen, "cpu")
    wrapped = apply_lora(cfg, params, LoraConfig(), gen, "cpu")
    with pytest.raises(ValueError, match="already has a LoRA adapter"):
        apply_lora(cfg, wrapped, LoraConfig(), gen, "cpu")
    mcfg = tiny_moe(vocab_size=64, embed_dim=32, n_layers=1, mlp_dim=64)
    mparams = init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="not in this model"):
        apply_lora(mcfg, mparams, LoraConfig(targets=("w_up",)), gen, "cpu")


def test_wrapped_forward_matches_jax_and_the_merge(jax_lora_tree):
    cfg, params = _port_tree(jax_lora_tree)
    toks = np.random.default_rng(4).integers(1, 128, (2, 20)).astype(np.int32)
    jlogits = jllama.LlamaModel(JCFG).forward(
        jax.tree_util.tree_map(jnp.asarray, jax_lora_tree),
        jnp.asarray(toks))
    model = LlamaModel(cfg, device="cpu")
    got = model.forward(params, torch.from_numpy(toks), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    merged = model.forward(merge_lora(params), torch.from_numpy(toks),
                           train=False)
    torch.testing.assert_close(got, merged, rtol=1e-4, atol=1e-4)
    base = {**params, "layers": {k: (v["w"] if is_lora(v) else v)
                                 for k, v in params["layers"].items()}}
    assert (got - model.forward(base, torch.from_numpy(toks),
                                train=False)).abs().max() > 1e-3


def test_gradients_reach_the_adapters_only(jax_lora_tree):
    cfg, params = _port_tree(jax_lora_tree)
    for w in params["layers"].values():
        if is_lora(w):
            w["w"].requires_grad_(True)
            w["lora_a"].requires_grad_(True)
            w["lora_b"].requires_grad_(True)
    model = LlamaModel(cfg, device="cpu")
    toks = torch.randint(1, 128, (1, 12), generator=torch.Generator()
                         .manual_seed(0))
    model.forward(params, toks, train=False).float().square().mean() \
        .backward()
    for t in TARGETS:
        w = params["layers"][t]
        assert w["w"].grad is None, t
        assert w["lora_a"].grad is not None and w["lora_a"].grad.abs().sum()
        assert w["lora_b"].grad is not None and w["lora_b"].grad.abs().sum()


def test_npz_written_by_jax_loads_here_and_the_reverse(jax_lora_tree,
                                                       tmp_path):
    jtree = jax.tree_util.tree_map(jnp.asarray, jax_lora_tree)
    jpath = jlora.save_adapter(str(tmp_path / "from_jax"), jtree)
    assert jpath.endswith(".npz")
    got = load_adapter(jpath)
    want = _numpy(jlora.extract_adapter(jtree))
    assert set(got) == set(TARGETS)
    for t in TARGETS:
        for k in ("a", "b", "scale"):
            np.testing.assert_array_equal(got[t][k], want[t][k])
    # and the port's tensors, from that file, for the engine
    ad = adapter_from_jax(got, device="cpu")
    assert torch.equal(ad["wq"]["a"], torch.tensor(want["wq"]["a"]))
    # the reverse: the port's file read by the JAX loader
    _, params = _port_tree(jax_lora_tree)
    ppath = save_adapter(str(tmp_path / "from_port.npz"), params)
    back = jlora.load_adapter(ppath)
    for t in TARGETS:
        for k in ("a", "b", "scale"):
            np.testing.assert_array_equal(back[t][k], want[t][k])


def test_bf16_adapters_cross_exactly(tmp_path):
    """bf16 A/B: the JAX file stores them as 2-byte raw bits, which the
    port widens to f32 exactly; the port writes bf16 as f32, exactly."""
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(2, 8, 4)), jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(2, 4, 8)), jnp.bfloat16)
    path = jlora.save_adapter(str(tmp_path / "bf16.npz"), {
        "wq": {"a": a, "b": b, "scale": jnp.full((2,), 2.0)}})
    got = load_adapter(path)
    assert got["wq"]["a"].dtype == np.float32
    np.testing.assert_array_equal(got["wq"]["a"],
                                  np.asarray(a.astype(jnp.float32)))
    np.testing.assert_array_equal(got["wq"]["b"],
                                  np.asarray(b.astype(jnp.float32)))
    ta = torch.from_numpy(got["wq"]["a"]).to(torch.bfloat16)
    path2 = save_adapter(str(tmp_path / "port_bf16"), {
        "wq": {"a": ta, "b": ta.transpose(1, 2), "scale": torch.ones(2)}})
    back = jlora.load_adapter(path2)
    np.testing.assert_array_equal(back["wq"]["a"], got["wq"]["a"])


def test_load_adapter_refuses_foreign_entries(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, **{"wq.a": np.zeros((1, 2, 2)), "wq.bogus": np.zeros(1)})
    with pytest.raises(ValueError, match="unexpected entry"):
        load_adapter(path)
    np.savez(path, **{"wq.a": np.zeros((1, 2, 2))})
    with pytest.raises(ValueError, match="missing"):
        load_adapter(path)
    with pytest.raises(ValueError, match="no LoRA adapters"):
        adapter_from_jax({"layers": {"wq": np.zeros((1, 2, 2))}}, "cpu")
