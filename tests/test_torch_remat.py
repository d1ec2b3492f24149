"""Remat policy "dots" in the port's ``LlamaModel.forward`` (selective
checkpointing: the outputs of the 2-D weight products kept, everything
else recomputed) on the CPU in f32.

- the loss and every gradient under "dots" equal those under "full" bit
  for bit (the kept products are the ones the recompute would redo) and
  those under "none" within 1e-6, on the dense tiny model with LoRA leaves
  and on the MLA tiny model; the policy was asked about the products and
  kept them;
- a JAX config with ``remat_policy="dots"`` carries across
  (``config_from_jax``) and trains three steps to the JAX trainer's losses
  and grad norms (1e-5 relative);
- an unknown policy is refused by name, as the JAX model refuses it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads import train as jtrain
from k8s_runpod_kubelet_tpu_torch.models import llama as pllama
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.lora import (LoraConfig,
                                                      apply_lora, lora_mask)
from k8s_runpod_kubelet_tpu_torch.workloads.train import (
    TrainConfig, Trainer, _leaves, loss_and_grads, trainable)

DIMS = dict(vocab_size=96, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=64)


def _params(cfg, lora):
    params = pllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                                master=True)
    mask = None
    if lora:
        params = apply_lora(cfg, params, LoraConfig(rank=4, targets=(
            "wq", "wo", "w_up")), torch.Generator().manual_seed(4), "cpu")
        with torch.no_grad():        # B off zero, so A's gradient is not 0
            for leaf in params["layers"].values():
                if isinstance(leaf, dict):
                    leaf["lora_b"].normal_(0, 0.05)
        mask = lora_mask(params)
    for p in _leaves(trainable(params, mask)):
        p.requires_grad_()
    return params, mask


@pytest.mark.parametrize("name,lora", [("tiny", False), ("tiny", True),
                                       ("tiny_mla", False)])
def test_dots_gradients_equal_full_and_none(name, lora, monkeypatch):
    cfg = getattr(pllama, name + ("_llama" if name == "tiny" else ""))(
        **DIMS, dtype=torch.float32)
    params, mask = _params(cfg, lora)
    batch = torch.from_numpy(np.random.default_rng(5).integers(
        0, DIMS["vocab_size"], (2, 17)))
    asked = []
    real = pllama._dots_policy

    def spy(ctx, op, *a, **kw):
        decision = real(ctx, op, *a, **kw)
        asked.append((op, decision))
        return decision

    monkeypatch.setattr(pllama, "_dots_policy", spy)
    out = {}
    for policy in ("full", "dots", "none"):
        model = pllama.LlamaModel(dataclasses.replace(cfg,
                                                      remat_policy=policy),
                                  "cpu")
        out[policy] = loss_and_grads(model, params, batch,
                                     trainable_mask=mask)
    (lf, gf), (ld, gd), (ln, gn) = out["full"], out["dots"], out["none"]
    assert torch.equal(lf, ld) and len(gf) == len(gd) == len(gn)
    assert all(torch.equal(a, b) for a, b in zip(gf, gd))
    torch.testing.assert_close(ld, ln, atol=1e-6, rtol=1e-6)
    for a, b in zip(gd, gn):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    kept = [op for op, d in asked if str(d).endswith("MUST_SAVE")]
    assert kept and all(op in pllama._SAVED_DOTS for op in kept)
    assert any(not str(d).endswith("MUST_SAVE") for _, d in asked)


def test_a_jax_dots_config_trains_to_the_jax_losses():
    jcfg = jllama.tiny_llama(**DIMS, dtype=jnp.float32,
                             param_dtype=jnp.float32, remat_policy="dots")
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(8)))
    cfg = config_from_jax(jcfg, torch.float32)
    assert cfg.remat_policy == "dots"
    kw = dict(learning_rate=1e-2, warmup_steps=1, steps=3, batch_size=2,
              seq_len=16)
    jtr = jtrain.Trainer(jcfg, jtrain.TrainConfig(**kw), initial_params=tree)
    ptr = Trainer(cfg, TrainConfig(**kw), device="cpu",
                  initial_params=params_from_jax(tree, cfg, "cpu",
                                                 master=True))
    rng = np.random.default_rng(6)
    for i in range(3):
        batch = rng.integers(0, DIMS["vocab_size"], (2, 17)).astype(np.int32)
        jtr.params, jtr.opt_state, jm = jtr.step_fn(
            jtr.params, jtr.opt_state, jnp.asarray(batch))
        m = ptr.step_fn(ptr.params, ptr.opt_state, torch.from_numpy(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"{k}, step {i}")


def test_an_unknown_policy_is_refused():
    cfg = pllama.tiny_llama(**DIMS, dtype=torch.float32,
                            remat_policy="everything")
    params, _ = _params(pllama.tiny_llama(**DIMS, dtype=torch.float32),
                        False)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        pllama.LlamaModel(cfg, "cpu").forward(
            params, torch.zeros((1, 4), dtype=torch.long))
