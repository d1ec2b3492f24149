"""Sequence-sharded training in the port against the JAX package, on the
CPU in f32: the model and the trainer under an in-process mesh with
seq = 2, whose attention is ring attention.

- ``config_from_jax`` carries ``ring_flash``;
- ``LlamaModel(tiny, mesh=seq 2)`` logits, ``ring_flash`` on and off,
  against the JAX ``LlamaModel`` under ``MeshConfig(data=1, fsdp=2,
  seq=2, tensor=2)`` (the pattern of ``tests/test_models_train.py:413``),
  and against the port's own unsharded forward: atol 1e-4 (f32 products
  summed in other orders over two layers, as ``tests/test_torch_train.py``);
- three ``Trainer`` steps on a seq = 2 mesh, ``ring_flash`` on and off,
  against the JAX ``Trainer`` on ``MeshConfig(data=1, fsdp=4, seq=2)``
  (``warmup_steps=1``, lr 1e-2): loss and grad norm rtol 1e-5, every
  parameter atol 1e-4 after each step (the tolerance of
  ``tests/test_torch_train.py``, whose docstring gives its grounds). The
  JAX package runs its XLA ring on the CPU whatever ``ring_flash`` says;
  the port runs the flash ring through its kernels' plain versions;
- ``Trainer`` refuses a process-group mesh, naming the ROADMAP item.
"""

import dataclasses
import types

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
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
from k8s_runpod_kubelet_tpu_torch.workloads.train import (TrainConfig,
                                                          Trainer, _leaves)

DIMS = dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=256)
B, S = 4, 16


def _jax_cfg(ring_flash):
    return jllama.tiny_llama(**DIMS, dtype=jnp.float32,
                             param_dtype=jnp.float32, ring_flash=ring_flash)


@pytest.fixture(scope="module")
def tree():
    """Seeded numpy parameters in the JAX tree layout (norm weights near 1
    so they matter)."""
    rng = np.random.default_rng(20261017)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape,
        jax_init_params(_jax_cfg(False), jax.random.PRNGKey(0)))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, DIMS["vocab_size"], (B, S + 1)).astype(np.int32)
            for _ in range(n)]


def test_config_from_jax_carries_ring_flash():
    for flag in (False, True):
        assert config_from_jax(_jax_cfg(flag), torch.float32).ring_flash \
            is flag


@pytest.fixture(scope="module")
def jax_seq_logits(tree):
    tokens = _batches(1)[0][:, :S]
    mesh = jmake_mesh(JMeshConfig(data=1, fsdp=2, seq=2, tensor=2))
    model = jllama.LlamaModel(_jax_cfg(True), mesh)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return tokens, np.asarray(jax.jit(model.forward)(params,
                                                     jnp.asarray(tokens)))


@pytest.mark.parametrize("ring_flash", [True, False])
def test_seq_sharded_logits_match_jax_and_the_unsharded_forward(
        tree, jax_seq_logits, ring_flash):
    tokens, jlogits = jax_seq_logits
    cfg = dataclasses.replace(config_from_jax(_jax_cfg(True), torch.float32),
                              ring_flash=ring_flash)
    params = params_from_jax(tree, cfg, device="cpu", master=True)
    tok = torch.from_numpy(tokens)
    sharded = LlamaModel(cfg, "cpu", make_mesh(MeshConfig(seq=2)))
    got = sharded.forward(params, tok).detach().numpy()
    np.testing.assert_allclose(got, jlogits, atol=1e-4, rtol=0)
    flat = LlamaModel(cfg, "cpu").forward(params, tok).detach().numpy()
    np.testing.assert_allclose(got, flat, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def jax_three_steps(tree):
    """Loss, grad norm and every parameter after each of three JAX steps
    on the seq = 2 mesh."""
    jtc = jtrain.TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=3,
                             batch_size=B, seq_len=S)
    mesh = jmake_mesh(JMeshConfig(data=1, fsdp=4, seq=2))
    trainer = jtrain.Trainer(_jax_cfg(True), jtc, mesh=mesh,
                             initial_params=tree)
    out = []
    for batch in _batches(3):
        trainer.params, trainer.opt_state, m = trainer.step_fn(
            trainer.params, trainer.opt_state, jnp.asarray(batch))
        leaves = [np.asarray(x) for _, x in sorted(
            jax.tree_util.tree_flatten_with_path(trainer.params)[0],
            key=lambda kv: [str(k.key) for k in kv[0]])]
        out.append((float(m["loss"]), float(m["grad_norm"]), leaves))
    return out


@pytest.mark.parametrize("ring_flash", [True, False])
def test_three_seq_sharded_train_steps_match_jax(tree, jax_three_steps,
                                                 ring_flash):
    cfg = dataclasses.replace(config_from_jax(_jax_cfg(True), torch.float32),
                              ring_flash=ring_flash)
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=3,
                     batch_size=B, seq_len=S)
    trainer = Trainer(cfg, tc, device="cpu",
                      initial_params=params_from_jax(tree, cfg, "cpu",
                                                     master=True),
                      mesh=make_mesh(MeshConfig(seq=2)))
    assert trainer.model.mesh.seq == 2
    for i, (batch, (jloss, jnorm, jleaves)) in enumerate(
            zip(_batches(3), jax_three_steps)):
        m = trainer.step_fn(trainer.params, trainer.opt_state,
                            torch.from_numpy(batch))
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=1e-5,
                                   err_msg=f"grad_norm, step {i}")
        for got, want in zip(_leaves(trainer.params), jleaves):
            np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                                       rtol=0, err_msg=f"step {i}")


def test_trainer_refuses_a_process_group_mesh():
    cfg = config_from_jax(_jax_cfg(True), torch.float32)
    group_mesh = types.SimpleNamespace(in_process=False, seq=2, rank=0)
    with pytest.raises(ValueError, match="Queue 1 #7.8"):
        Trainer(cfg, TrainConfig(batch_size=B, seq_len=S), device="cpu",
                mesh=group_mesh)
