"""The port's training path against the JAX package's, on the same numpy
parameters and batches, in f32 on the CPU.

- ``LlamaModel.forward`` logits against the JAX ``LlamaModel.forward`` on
  a small ``tiny_llama`` (atol 1e-4: f32 products summed in other orders
  over two layers), with and without explicit positions;
- three train steps of the port (``Trainer.step_fn``) against the JAX
  ``make_train_step`` (``warmup_steps=1``, lr 1e-2, remat on): the loss
  and ``grad_norm`` (rtol 1e-5) and every parameter after each step (atol
  1e-4, 1% of a step: the first update moves nothing, the next two move
  each weight by up to lr = 1e-2; the gradients agree to 1e-7, but Adam
  divides each by its own running rms, so an element whose gradient is
  near 1e-5 moves up to 4e-5 apart between the frameworks). Cases: plain,
  ``grad_accum_steps=2`` (strided microbatches) and ``z_loss_coef > 0``;
- the three optax semantics the optimizer keeps, each against optax
  itself: the schedule read before the update (the first update moves
  nothing), decoupled weight decay on every leaf, and the clip without an
  epsilon;
- ``Trainer`` save -> a new ``Trainer`` restores -> the same next loss,
  with both log markers the kubelet parses;
- ``train_main --device cpu --model tiny`` prints its JSON summary and a
  second life resumes from the first one's checkpoint.
"""

import json
import logging

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads import train as jtrain
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import train_main
from k8s_runpod_kubelet_tpu_torch.workloads.train import (
    B1, Optimizer, TrainConfig, Trainer, _leaves, warmup_cosine_decay)

DIMS = dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
            n_kv_heads=2, mlp_dim=128, max_seq_len=256)
B, S = 4, 16


def _jax_cfg():
    return jllama.tiny_llama(**DIMS, dtype=jnp.float32,
                             param_dtype=jnp.float32)


@pytest.fixture(scope="module")
def tree():
    """Seeded numpy parameters in the JAX tree layout (norm weights near 1
    so they matter)."""
    rng = np.random.default_rng(20261016)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax_init_params(_jax_cfg(), jax.random.PRNGKey(0)))

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


@pytest.mark.parametrize("positions", [False, True])
def test_forward_logits_match_jax(tree, positions):
    jcfg = _jax_cfg()
    cfg = config_from_jax(jcfg, torch.float32)
    assert cfg.remat and cfg.remat_policy == "full"
    tokens = _batches(1)[0][:, :S]
    pos = (np.arange(S)[None, :] * 2 + np.arange(B)[:, None]).astype(
        np.int32) if positions else None
    jlogits = jllama.LlamaModel(jcfg).forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens),
        None if pos is None else jnp.asarray(pos))
    model = LlamaModel(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu", master=True)
    logits = model.forward(params, torch.from_numpy(tokens),
                           None if pos is None else torch.from_numpy(pos))
    assert logits.shape == (B, S, DIMS["vocab_size"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    hidden = model.forward(params, torch.from_numpy(tokens),
                           return_hidden=True)
    assert hidden.shape == (B, S, DIMS["embed_dim"])


@pytest.mark.parametrize("accum,z_loss", [(1, 0.0), (2, 0.0), (1, 1e-3)])
def test_three_train_steps_match_jax(tree, accum, z_loss):
    jcfg = _jax_cfg()
    jtc = jtrain.TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=3,
                             batch_size=B, seq_len=S, z_loss_coef=z_loss,
                             grad_accum_steps=accum)
    jmodel = jllama.LlamaModel(jcfg)
    jopt = jtrain.make_optimizer(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jtrain.make_train_step(jmodel, jopt, donate=False,
                                   grad_accum_steps=accum,
                                   z_loss_coef=z_loss)

    cfg = config_from_jax(jcfg, torch.float32)
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=3,
                     batch_size=B, seq_len=S, z_loss_coef=z_loss,
                     grad_accum_steps=accum)
    trainer = Trainer(cfg, tc, device="cpu",
                      initial_params=params_from_jax(tree, cfg, "cpu",
                                                     master=True))
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
            np.testing.assert_allclose(
                got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0,
                err_msg=f"{jax.tree_util.keystr(path)}, step {i}")


def _toy_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "norm": (1 + 0.1 * rng.normal(size=(4,))).astype(np.float32)}


def _run_optimizers(port_opt, optax_opt, grads_seq):
    params = _toy_tree(0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = optax_opt.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = port_opt.init(tparams)
    for grads in grads_seq:
        updates, jstate = optax_opt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port_opt.update([torch.from_numpy(grads[k]) for k in sorted(grads)],
                        tstate, tparams)
    return jparams, tparams


def test_schedule_is_read_before_the_update():
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10)
    ours = warmup_cosine_decay(0.0, 1e-2, 3, 10)
    for count in range(14):
        assert ours(count) == pytest.approx(float(sched(count)), rel=1e-6,
                                            abs=1e-12)
    # warmup from 0: the first update moves nothing, weight decay included
    opt = Optimizer(ours, grad_clip=1.0, weight_decay=0.1)
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    opt.update([torch.full((3,), 0.5)], state, params)
    assert torch.equal(params["w"], torch.ones(3)) and state["count"] == 1
    opt.update([torch.full((3,), 0.5)], state, params)
    assert not torch.equal(params["w"], torch.ones(3))


def test_adamw_decays_every_leaf_with_the_scheduled_lr():
    sched = warmup_cosine_decay(0.0, 0.1, 1, 5)
    optax_opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 0.1, 1,
                                                               5),
                            b1=0.9, b2=0.95, weight_decay=0.1)
    port_opt = Optimizer(sched, grad_clip=1e9, weight_decay=0.1)
    # the norm leaf gets zero gradients: only decoupled decay moves it
    grads = [{"w": np.random.default_rng(i).normal(size=(3, 4))
              .astype(np.float32), "norm": np.zeros(4, np.float32)}
             for i in range(4)]
    jparams, tparams = _run_optimizers(port_opt, optax_opt, grads)
    for k in ("w", "norm"):
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert not np.allclose(tparams["norm"].numpy(), _toy_tree(0)["norm"])


@pytest.mark.parametrize("scale", [0.3, 1.0, 40.0])
def test_clip_matches_optax_clip_by_global_norm(scale):
    g = {"w": np.full((3, 4), scale, np.float32),
         "norm": np.full(4, scale, np.float32)}
    norm = float(np.sqrt(16) * scale)
    port_opt = Optimizer(lambda c: 1.0, grad_clip=4.0, weight_decay=0.0)
    params = {k: torch.zeros(v.shape) for k, v in g.items()}
    state = port_opt.init(params)
    port_opt.update([torch.from_numpy(g[k]) for k in sorted(g)], state,
                    params)
    # the first moment after one update is (1 - b1) times the clipped
    # gradient
    clipped, _ = optax.clip_by_global_norm(4.0).update(
        jax.tree_util.tree_map(jnp.asarray, g), None)
    for k in g:
        np.testing.assert_allclose(state["mu"][k].numpy() / (1 - B1),
                                   np.asarray(clipped[k]), rtol=1e-6)
    want = min(1.0, 4.0 / norm) * scale
    np.testing.assert_allclose(state["mu"]["w"].numpy() / (1 - B1), want,
                               rtol=1e-6)


def test_save_restore_gives_the_same_next_loss(tree, tmp_path, caplog):
    cfg = config_from_jax(_jax_cfg(), torch.float32)
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=4,
                     batch_size=B, seq_len=S,
                     checkpoint_dir=str(tmp_path / "ck"))
    init = params_from_jax(tree, cfg, "cpu", master=True)
    a = Trainer(cfg, tc, device="cpu", initial_params=init)
    batches = [torch.from_numpy(b) for b in _batches(3, seed=9)]
    for b in batches[:2]:
        a.step_fn(a.params, a.opt_state, b)
        a.step += 1
    with caplog.at_level(logging.INFO):
        a.save()
        b_ = Trainer(cfg, tc, device="cpu", seed=123)
        assert b_.restore() and b_.step == 2
    assert "checkpoint saved at step 2" in caplog.text
    assert "resumed from checkpoint step 2" in caplog.text
    la = a.step_fn(a.params, a.opt_state, batches[2])
    lb = b_.step_fn(b_.params, b_.opt_state, batches[2])
    assert float(la["loss"]) == float(lb["loss"])
    for x, y in zip(_leaves(a.params), _leaves(b_.params)):
        assert torch.equal(x, y)


def test_train_main_prints_summary_and_resumes(tmp_path, capsys, caplog,
                                               monkeypatch):
    monkeypatch.setenv("TPU_CHECKPOINT_DIR", str(tmp_path / "ck"))
    argv = ["--device", "cpu", "--model", "tiny", "--steps", "2", "--batch",
            "2", "--seq-len", "8", "--eval-steps", "1"]
    with caplog.at_level(logging.INFO):
        assert train_main.main(argv) == 0
        first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        monkeypatch.setenv("TPU_RESTART_ATTEMPT", "1")
        assert train_main.main(argv) == 0
        second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for out in (first, second):
        assert out["workload"] == "pretrain" and out["model"] == "tiny"
        assert out["devices"] == 1 and out["steps"] == 2
        assert np.isfinite(out["final_loss"]) and "eval_loss" in out
        assert out["tokens_per_s_per_chip"] > 0
    assert "checkpoint saved at step 2" in caplog.text
    assert "resumed from checkpoint step 2" in caplog.text
    assert "checkpoint saved at step 4" in caplog.text


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default resolves to it")
    cfg = config_from_jax(_jax_cfg(), torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main.main(["--model", "tiny", "--steps", "1"])
