"""The port's chunked fused cross-entropy (``ops/fused_ce.py``) against the
JAX package's ``fused_cross_entropy`` and against the port's naive loss
``_ce_and_zloss``, on the CPU, with seeded numpy inputs.

- values (ce, z) and gradients in hidden and head, tied (tok_embed rows)
  and untied (lm_head columns), soft cap 30 on and off, z-loss 1e-4 on and
  off, 6 chunks of a 96-token vocab: port vs JAX at 2e-5 (f32 products
  summed in other orders), port vs the naive loss at 2e-5;
- ``_pick_chunks`` against the JAX function (requested counts that divide
  the vocab, that do not, a prime vocab, one chunk), and the fused loss at
  5 requested chunks (4 taken) and at 1 against the naive one;
- bf16 hidden states over an f32 head: the head chunks are cast to bf16
  and multiplied with f32 results on both sides (port vs JAX 1e-3
  relative on the values, 2e-2 relative L2 on the gradients: bf16 inputs
  rounded to bf16 outputs);
- a frozen head (no ``requires_grad``) gets no gradient, hidden's is the
  same;
- the fused train step against the naive one over three steps of the
  port's ``Trainer`` (loss 1e-4, every parameter 5e-4, the JAX file's
  tolerances), and the port's fused step against the JAX fused step on the
  same parameters and batches (loss and grad_norm 1e-5, parameters 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.ops import fused_ce as jfce
from k8s_runpod_kubelet_tpu.workloads import train as jtrain
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.ops.fused_ce import (_pick_chunks,
                                                       fused_cross_entropy)
from k8s_runpod_kubelet_tpu_torch.workloads.train import (TrainConfig,
                                                          Trainer, _ce_and_zloss,
                                                          _leaves)

B, S, E, V = 2, 16, 32, 96


def _inputs(seed=0, v=V):
    rng = np.random.default_rng(seed)
    return dict(h=rng.normal(size=(B, S, E)).astype(np.float32),
                wu=(0.1 * rng.normal(size=(E, v))).astype(np.float32),
                wt=(0.1 * rng.normal(size=(v, E))).astype(np.float32),
                t=rng.integers(0, v, (B, S)).astype(np.int32))


def _port(x, tied, cap, coef, n_chunks, dtype=torch.float32):
    h = torch.from_numpy(x["h"]).to(dtype).requires_grad_()
    w = torch.from_numpy(x["wt"] if tied else x["wu"]).requires_grad_()
    ce, z = fused_cross_entropy(h, w, torch.from_numpy(x["t"]), tied=tied,
                                z_loss_coef=coef, logit_softcap=cap,
                                n_chunks=n_chunks)
    dh, dw = torch.autograd.grad(ce + z, (h, w))
    return ce.item(), z.item(), dh.float().numpy(), dw.numpy()


def _naive(x, tied, cap, coef):
    h = torch.from_numpy(x["h"]).requires_grad_()
    w = torch.from_numpy(x["wt"] if tied else x["wu"]).requires_grad_()
    logits = h @ (w.t() if tied else w)
    if cap:
        logits = torch.tanh(logits / cap) * cap
    ce, z = _ce_and_zloss(logits, torch.from_numpy(x["t"]), coef)
    dh, dw = torch.autograd.grad(ce + z, (h, w))
    return ce.item(), z.item(), dh.numpy(), dw.numpy()


def _jax(x, tied, cap, coef, n_chunks, dtype=jnp.float32):
    w = jnp.asarray(x["wt"] if tied else x["wu"])

    def f(h, w):
        ce, z = jfce.fused_cross_entropy(h.astype(dtype), w,
                                         jnp.asarray(x["t"]), tied=tied,
                                         z_loss_coef=coef,
                                         logit_softcap=cap,
                                         n_chunks=n_chunks)
        return ce + z, (ce, z)

    (_, (ce, z)), (dh, dw) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x["h"]), w)
    return float(ce), float(z), np.asarray(dh), np.asarray(dw)


CASES = [(tied, cap, coef) for tied in (False, True) for cap in (None, 30.0)
         for coef in (0.0, 1e-4)]


@pytest.mark.parametrize("tied,cap,coef", CASES,
                         ids=lambda v: str(v))
def test_values_and_grads_match_jax_and_the_naive_loss(tied, cap, coef):
    x = _inputs(1)
    port = _port(x, tied, cap, coef, 6)
    for name, want in (("jax", _jax(x, tied, cap, coef, 6)),
                       ("naive", _naive(x, tied, cap, coef))):
        for what, a, b in zip(("ce", "z", "dh", "dw"), port, want):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5,
                                       err_msg=f"{what} vs {name}")
    if not coef:
        assert port[1] == 0.0


@pytest.mark.parametrize("v,requested", [(96, 6), (96, 5), (96, 7), (97, 8),
                                         (96, 1), (96, 200)])
def test_pick_chunks_matches_jax(v, requested):
    assert _pick_chunks(v, requested) == jfce._pick_chunks(v, requested)


@pytest.mark.parametrize("requested", [5, 1])
def test_chunk_counts_that_do_not_divide_and_one_chunk(requested):
    x = _inputs(2)
    port = _port(x, False, None, 1e-4, requested)
    want = _naive(x, False, None, 1e-4)
    for what, a, b in zip(("ce", "z", "dh", "dw"), port, want):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=what)


@pytest.mark.parametrize("tied", [False, True])
def test_bf16_hidden_over_an_f32_head_matches_jax(tied):
    x = _inputs(3)
    ce, z, dh, dw = _port(x, tied, None, 1e-4, 6, torch.bfloat16)
    jce, jz, jdh, jdw = _jax(x, tied, None, 1e-4, 6, jnp.bfloat16)
    np.testing.assert_allclose(ce, jce, rtol=1e-3)
    np.testing.assert_allclose(z, jz, rtol=1e-3)
    for a, b in ((dh, jdh), (dw, jdw)):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2


def test_a_frozen_head_gets_no_gradient():
    x = _inputs(4)
    h = torch.from_numpy(x["h"]).requires_grad_()
    w = torch.from_numpy(x["wu"])                 # frozen: no grad wanted
    ce, z = fused_cross_entropy(h, w, torch.from_numpy(x["t"]), n_chunks=6)
    (ce + z).backward()
    assert w.grad is None
    np.testing.assert_allclose(h.grad.numpy(), _naive(x, False, None,
                                                       0.0)[2],
                               rtol=2e-5, atol=2e-5)


DIMS = dict(vocab_size=96, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=64)
TB, TS = 4, 16


def _jax_cfg():
    return jllama.tiny_llama(**DIMS, dtype=jnp.float32,
                             param_dtype=jnp.float32)


@pytest.fixture(scope="module")
def tree():
    params = jllama.init_params(_jax_cfg(), jax.random.PRNGKey(5))
    return jax.tree_util.tree_map(np.asarray, params)


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, DIMS["vocab_size"], (TB, TS + 1))
            .astype(np.int32) for _ in range(n)]


def _port_trainer(tree, chunks):
    cfg = config_from_jax(_jax_cfg(), torch.float32)
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=3,
                     batch_size=TB, seq_len=TS, z_loss_coef=1e-4,
                     fused_ce_chunks=chunks)
    return Trainer(cfg, tc, device="cpu",
                   initial_params=params_from_jax(tree, cfg, "cpu",
                                                  master=True))


def test_fused_train_step_matches_the_naive_step(tree):
    runs = []
    for chunks in (0, 4):
        trainer = _port_trainer(tree, chunks)
        losses = [float(trainer.step_fn(trainer.params, trainer.opt_state,
                                        torch.from_numpy(b))["loss"])
                  for b in _batches(3)]
        runs.append((losses, [p.detach().numpy()
                              for p in _leaves(trainer.params)]))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-4, atol=1e-4)
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4)


def test_fused_train_step_matches_the_jax_fused_step(tree):
    jtc = jtrain.TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=3,
                             batch_size=TB, seq_len=TS, z_loss_coef=1e-4,
                             fused_ce_chunks=4)
    jopt = jtrain.make_optimizer(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jtrain.make_train_step(jllama.LlamaModel(_jax_cfg()), jopt,
                                   donate=False, z_loss_coef=1e-4,
                                   fused_ce_chunks=4)
    trainer = _port_trainer(tree, 4)
    for i, batch in enumerate(_batches(3)):
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(batch))
        m = trainer.step_fn(trainer.params, trainer.opt_state,
                            torch.from_numpy(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"grad_norm, step {i}")
    for (path, want), got in zip(
            sorted(jax.tree_util.tree_flatten_with_path(jparams)[0],
                   key=lambda kv: [str(k.key) for k in kv[0]]),
            _leaves(trainer.params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
