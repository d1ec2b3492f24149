"""LoRA training in the port (``Trainer(lora=)``, the masked optimizer,
``train_main --lora-rank/--export-adapter``) against the JAX package's,
on the CPU in f32.

- the JAX ``Trainer(lora=)`` and the port's on the same base tree (the
  weight bridge) and the same adapter init (the JAX trainer's A, drawn
  from its ``seed + 1`` key, copied into the port's; B is zero on both):
  four steps (the first moves nothing under a warmup of one), per-step
  loss and grad_norm within 1e-5 relative, A and B after the steps within
  1e-4, with and without ``grad_accum_steps=2``;
- the frozen leaves: no ``requires_grad``, bit-identical after the steps;
  the optimizer state holds moments for the LoRA leaves only, equal to
  the JAX ``multi_transform`` state's (1e-5 relative, 1e-8 absolute:
  moments of ~1e-3 whose smallest elements sit at f32 rounding);
- a frozen leaf held in the compute dtype changes nothing: on a bf16
  compute config the loss and every LoRA gradient are bit-identical to
  those of the same tree with its f32 master leaves;
- adapters cross both ways: the port's ``save_adapter`` of a trained
  adapter loads through the JAX ``load_adapter``, and the JAX one's through
  the port's, exactly;
- ``train_main --export-adapter`` without ``--lora-rank`` is the same
  usage error in both CLIs; with it, the port's CLI writes the adapter
  and logs the ``LoRA r=...: ...M trainable`` line.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import lora as jlora
from k8s_runpod_kubelet_tpu.workloads import train as jtrain
from k8s_runpod_kubelet_tpu.workloads import train_main as jtrain_main
from k8s_runpod_kubelet_tpu_torch.models import lora as plora
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import train_main
from k8s_runpod_kubelet_tpu_torch.workloads.train import (
    TrainConfig, Trainer, _leaves, loss_and_grads, trainable)

DIMS = dict(vocab_size=96, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=64)
B, S = 4, 16
TARGETS = ("wq", "wv", "w_down")


def _jax_cfg():
    return jllama.tiny_llama(**DIMS, dtype=jnp.float32,
                             param_dtype=jnp.float32)


@pytest.fixture(scope="module")
def tree():
    params = jllama.init_params(_jax_cfg(), jax.random.PRNGKey(11))
    return jax.tree_util.tree_map(np.asarray, params)


def _batches(n, seed=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, DIMS["vocab_size"], (B, S + 1)).astype(np.int32)
            for _ in range(n)]


def _trainers(tree, accum):
    kw = dict(learning_rate=1e-2, warmup_steps=1, steps=4, batch_size=B,
              seq_len=S, grad_accum_steps=accum)
    jtr = jtrain.Trainer(_jax_cfg(), jtrain.TrainConfig(**kw),
                         initial_params=tree,
                         lora=jlora.LoraConfig(rank=4, alpha=8.0,
                                               targets=TARGETS))
    cfg = config_from_jax(_jax_cfg(), torch.float32)
    ptr = Trainer(cfg, TrainConfig(**kw), device="cpu",
                  initial_params=params_from_jax(tree, cfg, "cpu",
                                                 master=True),
                  lora=plora.LoraConfig(rank=4, alpha=8.0, targets=TARGETS))
    with torch.no_grad():
        for t in TARGETS:
            ptr.params["layers"][t]["lora_a"].copy_(torch.from_numpy(
                np.array(jtr.params["layers"][t]["lora_a"])))
    return jtr, ptr


@pytest.mark.parametrize("accum", [1, 2])
def test_lora_steps_match_jax_with_the_base_frozen(tree, accum):
    jtr, ptr = _trainers(tree, accum)
    mask = ptr.trainable_mask
    frozen = [p.clone() for p in _leaves(ptr.params)
              if not p.requires_grad]
    assert len(_leaves(trainable(ptr.params, mask))) == 2 * len(TARGETS)
    for i, batch in enumerate(_batches(4)):
        jtr.params, jtr.opt_state, jm = jtr.step_fn(
            jtr.params, jtr.opt_state, jnp.asarray(batch))
        m = ptr.step_fn(ptr.params, ptr.opt_state, torch.from_numpy(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"grad_norm, step {i}")
    for t in TARGETS:
        for k in ("lora_a", "lora_b"):
            np.testing.assert_allclose(
                ptr.params["layers"][t][k].detach().numpy(),
                np.asarray(jtr.params["layers"][t][k]), atol=1e-4, rtol=0,
                err_msg=f"{t}.{k}")
        # B moved off zero: the adapters trained
        assert ptr.params["layers"][t]["lora_b"].abs().max() > 0
    after = [p for p in _leaves(ptr.params) if not p.requires_grad]
    assert len(after) == len(frozen)
    assert all(torch.equal(a, b) for a, b in zip(after, frozen))
    # moments for the LoRA leaves alone, equal to the JAX masked state's
    assert set(ptr.opt_state["mu"]) == {"layers"}
    assert set(ptr.opt_state["mu"]["layers"]) == set(TARGETS)
    assert all(set(v) == {"lora_a", "lora_b"}
               for v in ptr.opt_state["mu"]["layers"].values())
    assert ptr.opt_state["count"] == 4
    for name in ("mu", "nu"):
        want = jax.tree_util.tree_leaves(
            optax.tree_utils.tree_get(jtr.opt_state, name))
        got = _leaves(ptr.opt_state[name])
        assert len(got) == len(want) == 2 * len(TARGETS)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-8, err_msg=name)


def test_frozen_leaves_in_the_compute_dtype_change_nothing(tree):
    cfg = dataclasses.replace(config_from_jax(_jax_cfg(), torch.float32),
                              dtype=torch.bfloat16)
    master = params_from_jax(tree, cfg, "cpu", master=True)
    tc = TrainConfig(batch_size=B, seq_len=S)
    lc = plora.LoraConfig(rank=4, alpha=8.0, targets=TARGETS)
    tr = Trainer(cfg, tc, device="cpu", initial_params=master, lora=lc)
    layers = tr.params["layers"]
    assert layers["wk"].dtype == torch.bfloat16
    assert layers["wq"]["w"].dtype == torch.bfloat16
    assert tr.params["tok_embed"].dtype == torch.bfloat16
    assert layers["attn_norm"].dtype == torch.float32
    assert layers["wq"]["lora_a"].dtype == torch.float32
    assert layers["wq"]["scale"].dtype == torch.float32
    # the same tree with the f32 master leaves in the frozen places
    f32 = dict(master)
    f32["layers"] = dict(master["layers"])
    for t in TARGETS:
        f32["layers"][t] = dict(layers[t], w=master["layers"][t])
    batch = torch.from_numpy(_batches(1)[0])
    got = loss_and_grads(tr.model, tr.params, batch,
                         trainable_mask=tr.trainable_mask)
    want = loss_and_grads(tr.model, f32, batch,
                          trainable_mask=tr.trainable_mask)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_adapters_cross_both_ways(tree, tmp_path):
    jtr, ptr = _trainers(tree, 1)
    for batch in _batches(3):
        jtr.params, jtr.opt_state, _ = jtr.step_fn(
            jtr.params, jtr.opt_state, jnp.asarray(batch))
        ptr.step_fn(ptr.params, ptr.opt_state, torch.from_numpy(batch))
    port_file = plora.save_adapter(str(tmp_path / "port"), ptr.params)
    jax_file = jlora.save_adapter(str(tmp_path / "jax"), jtr.params)
    read_by_jax = jlora.load_adapter(port_file)
    read_by_port = plora.load_adapter(jax_file)
    assert set(read_by_jax) == set(read_by_port) == set(TARGETS)
    for t in TARGETS:
        for k, src in (("a", "lora_a"), ("b", "lora_b"), ("scale", "scale")):
            np.testing.assert_array_equal(
                np.asarray(read_by_jax[t][k]),
                ptr.params["layers"][t][src].detach().numpy())
            np.testing.assert_array_equal(
                read_by_port[t][k], np.asarray(jtr.params["layers"][t][src]))


def test_export_adapter_needs_lora_rank(capsys):
    for mod in (train_main, jtrain_main):
        with pytest.raises(SystemExit) as err:
            mod.main(["--model", "tiny", "--export-adapter", "x.npz"])
        assert err.value.code == 2
        assert "--export-adapter needs --lora-rank" in capsys.readouterr().err


def test_train_main_exports_the_trained_adapter(tmp_path, caplog):
    out = tmp_path / "adapter.npz"
    with caplog.at_level(logging.INFO):
        assert train_main.main([
            "--device", "cpu", "--model", "tiny", "--steps", "2", "--batch",
            "2", "--seq-len", "8", "--lora-rank", "4", "--lora-targets",
            "wq,wo", "--export-adapter", str(out)]) == 0
    assert "LoRA r=4: " in caplog.text and "M trainable of" in caplog.text
    ad = plora.load_adapter(str(out))
    assert set(ad) == {"wq", "wo"} and ad["wq"]["a"].shape[-1] == 4
