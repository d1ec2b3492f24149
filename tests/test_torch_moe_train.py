"""Training a sparse-MoE model in the port against the JAX package's
trainer, on the CPU in f32.

Three tiny shapes, their parameters drawn from a seed with numpy into the
JAX tree layout and carried over by ``params_from_jax``: ``tiny-moe``
(Mixtral's softmax top-2 over 4 experts, renormalized), DeepSeek-V2 (MLA,
4 experts top-2 without renormalization, 2 shared experts, one dense
prefix layer) and DeepSeek-V3 (sigmoid routing over 8 experts in 4 groups
keeping 2, a correction bias, scaling 2.5, the low-rank q). Routers are
drawn decisive (normal * 1.0) so that f32 rounding cannot reorder an
expert choice between the packages. Training routes at the configs'
capacity factor 1.25, so assignments drop. Checked:

- ``moe_mlp``'s gradients (autograd) against ``jax.grad`` of the JAX
  ``moe_mlp`` through ``sum(y^2) + 0.01 aux + 0.001 z`` for h, the router
  and the three expert leaves: ample capacity, forced drops (capacity
  factor 0.5), ``norm_topk=False`` and V3's routing, whose correction bias
  reaches no output (no autograd path; an exact zero from ``jax.grad``);
  within 1e-5 relative to the largest element;
- ``forward(with_aux=True)`` logits and aux against the JAX forward's on
  all three shapes under remat "full" and "dots" (logits within 1e-4, aux
  within 1e-5 relative), and the gradients of CE + aux of every leaf under
  each policy equal to those without remat (within 1e-6 relative to each
  leaf's largest element);
- three ``Trainer.step_fn`` steps against the JAX ``make_train_step``
  (``warmup_steps=1``, lr 1e-2): loss and ``aux_loss`` within 1e-5
  relative, ``grad_norm`` within 1e-5, every leaf within 1e-4 after every
  step (as ``test_torch_train.py`` holds the dense step), for ``tiny-moe``
  alone and with ``grad_accum_steps=2`` and ``z_loss_coef`` 1e-3, V2,
  V3 (its ``router_bias`` gradient exactly zero, the bias decayed as
  optax decays it) and the fused chunked CE over an MoE model;
- two LoRA steps against the JAX ``Trainer(lora=)`` (A copied from the
  JAX trainer's draw): ``tiny-moe`` on wq, wv and V2 on wq, wo; the dense
  prefix, the experts and the router unchanged bit for bit; ``wv`` on an
  MLA model refused with the JAX message;
- the step on an in-process ``seq``-2 mesh (ring attention over the
  sequence, the experts over all of it) equal to the unsharded step;
- save, restore into a new trainer, the same next loss and aux;
  ``train_main --model tiny-moe`` prints its summary and a second life
  resumes.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import lora as jlora
from k8s_runpod_kubelet_tpu.models import moe as jmoe
from k8s_runpod_kubelet_tpu.workloads import train as jtrain
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models import lora as plora
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.models.moe import moe_mlp
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
from k8s_runpod_kubelet_tpu_torch.workloads import train_main
from k8s_runpod_kubelet_tpu_torch.workloads.train import (
    TrainConfig, Trainer, _ce_and_zloss, _leaves, loss_aux_and_grads,
    trainable)

B, S = 2, 16
MLA_DIMS = dict(vocab_size=128, embed_dim=64, n_layers=3, n_heads=4,
                n_kv_heads=4, head_dim=16, mla_latent_dim=32,
                mla_rope_dim=8, mlp_dim=48, max_seq_len=64,
                n_dense_prefix=1, dense_prefix_mlp_dim=112)
SHAPES = {
    "moe": dict(vocab_size=128, embed_dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, mlp_dim=64, max_seq_len=64),
    "v2": dict(MLA_DIMS, n_experts=4, n_experts_per_tok=2,
               n_shared_experts=2, router_norm_topk=False),
    "v3": dict(MLA_DIMS, mla_q_lora_rank=24, n_experts=8,
               n_experts_per_tok=2, n_shared_experts=1,
               router_norm_topk=True, router_sigmoid_bias=True,
               router_n_group=4, router_topk_group=2,
               routed_scaling_factor=2.5),
}


def jax_cfg(shape: str, **kw):
    make = jllama.tiny_moe if shape == "moe" else jllama.tiny_mla
    return make(**SHAPES[shape], dtype=jnp.float32, param_dtype=jnp.float32,
                **kw)


def numpy_tree(jcfg, seed: int = 20261019):
    """Seeded numpy parameters in the JAX tree layout: norms near 1, the
    router decisive (normal * 1.0), V3's correction bias normal * 0.3, the
    rest normal * 0.08."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(jcfg, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        name = str(path[-1].key)
        if name.endswith("norm"):
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        scale = {"router": 1.0, "router_bias": 0.3}.get(name, 0.08)
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def batches(n: int, vocab: int, b: int = B, seed: int = 7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (b, S + 1)).astype(np.int32)
            for _ in range(n)]


def sorted_jax_leaves(tree):
    """(path, leaf) of a JAX tree in the port's ``_leaves`` order."""
    return sorted(jax.tree_util.tree_flatten_with_path(tree)[0],
                  key=lambda kv: [str(k.key) for k in kv[0]])


def close_to_max(got, want, rel, what):
    """Each element within ``rel`` x the largest magnitude of ``want``."""
    want = np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0,
                               err_msg=what)


# -- (1) moe_mlp's gradients ------------------------------------------------------

MLP_CASES = {
    "ample": dict(capacity_factor=2.0),
    "drops": dict(capacity_factor=0.5),
    "raw_topk": dict(capacity_factor=1.25, norm_topk=False),
    "v3": dict(capacity_factor=1.25, v3=True),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_moe_mlp_gradients_match_jax_grad(case):
    kw = dict(MLP_CASES[case])
    v3 = kw.pop("v3", False)
    rng = np.random.default_rng(20261020)
    x, e, m, k, b, s = 8 if v3 else 4, 32, 48, 2, 2, 12
    w = {"h": rng.normal(size=(b, s, e)),
         "router": rng.normal(size=(e, x)) * 0.5,
         "we_gate": 0.1 * rng.normal(size=(x, e, m)),
         "we_up": 0.1 * rng.normal(size=(x, e, m)),
         "we_down": 0.1 * rng.normal(size=(x, m, e))}
    if v3:
        w["router_bias"] = 0.3 * rng.normal(size=(x,))
        route = dict(norm_topk=True, router_n_group=4, router_topk_group=2,
                     routed_scaling=2.5)
    else:
        route = dict(norm_topk=kw.pop("norm_topk", True))
    w = {n: v.astype(np.float32) for n, v in w.items()}

    def jloss(p):
        y, aux, z = jmoe.moe_mlp(
            p["h"], p["router"], p["we_gate"], p["we_up"], p["we_down"],
            n_experts_per_tok=k, activation=jax.nn.silu, dtype=jnp.float32,
            router_bias=p.get("router_bias"), **route, **kw)
        return jnp.sum(y ** 2) + 0.01 * aux + 0.001 * z

    jgrads = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, w))
    t = {n: torch.from_numpy(v).requires_grad_() for n, v in w.items()}
    y, aux, z = moe_mlp(t["h"], t["router"], t["we_gate"], t["we_up"],
                        t["we_down"], n_experts_per_tok=k, dtype=torch.float32,
                        router_bias=t.get("router_bias"), **route, **kw)
    loss = y.square().sum() + 0.01 * aux + 0.001 * z
    np.testing.assert_allclose(float(loss.detach()), float(jloss(w)),
                               rtol=1e-6)
    names = sorted(t)
    grads = dict(zip(names, torch.autograd.grad(loss, [t[n] for n in names],
                                                allow_unused=True)))
    if case == "drops":
        # the capacity really drops: fewer than all G*k assignments kept
        from k8s_runpod_kubelet_tpu_torch.models.moe import (
            dispatch_positions, moe_capacity, route_top_k)
        cap = moe_capacity(b * s, x, k, 0.5)
        _, idx, _ = route_top_k(t["h"].reshape(-1, e) @ t["router"], k)
        assert int(dispatch_positions(idx, x, cap)[1].sum()) < b * s * k
    for n in names:
        if n == "router_bias":
            # selection only: no autograd path, and an exact zero in JAX
            assert grads[n] is None
            assert not np.asarray(jgrads[n]).any()
            continue
        assert grads[n] is not None and bool(grads[n].abs().max() > 0), n
        close_to_max(grads[n].numpy(), jgrads[n], 1e-5, n)


# -- (2) forward(with_aux=True) ------------------------------------------------------

_JAX_FORWARD: dict = {}


def _jax_forward(shape: str):
    """(numpy tree, tokens, JAX logits, JAX aux) of one shape, computed
    once: the remat policy changes no forward value."""
    if shape not in _JAX_FORWARD:
        jcfg = jax_cfg(shape)
        tree = numpy_tree(jcfg)
        tokens = batches(1, jcfg.vocab_size)[0][:, :-1]
        logits, aux = jax.jit(lambda p, t: jllama.LlamaModel(jcfg).forward(
            p, t, with_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree),
                                  jnp.asarray(tokens))
        _JAX_FORWARD[shape] = (tree, tokens, np.asarray(logits), float(aux))
    return _JAX_FORWARD[shape]


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_with_aux_matches_jax_under_remat(shape, policy):
    """Logits and aux against the JAX forward; the gradients of CE + aux
    of every leaf under ``policy`` equal those without remat (which the
    step tests hold against JAX's): the routing recomputed in backward
    comes out as in forward, the aux passes out of the checkpoint."""
    tree, tokens, jlogits, jaux = _jax_forward(shape)
    cfg = config_from_jax(jax_cfg(shape), torch.float32)
    targets = torch.from_numpy(batches(1, cfg.vocab_size)[0][:, 1:])
    grads = {}
    for pol in (policy, "none"):
        pcfg = dataclasses.replace(cfg, remat_policy=pol)
        params = params_from_jax(tree, pcfg, device="cpu", master=True)
        leaves = [p.requires_grad_() for p in _leaves(params)]
        logits, aux = LlamaModel(pcfg, device="cpu").forward(
            params, torch.from_numpy(tokens), with_aux=True)
        np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(float(aux.detach()), jaux, rtol=1e-5)
        ce, _ = _ce_and_zloss(logits, targets, 0.0)
        grads[pol] = torch.autograd.grad(ce + aux, leaves, allow_unused=True)
    if shape == "v3":
        assert jaux == 0.0          # aux-free balancing
    else:
        assert jaux > 0.0
    names = [jax.tree_util.keystr(p) for p, _ in sorted_jax_leaves(tree)]
    for name, got, want in zip(names, grads[policy], grads["none"]):
        if want is None:
            assert got is None and name.endswith("['router_bias']")
            continue
        close_to_max(got.numpy(), want.numpy(), 1e-6, name)


# -- (3) three train steps -------------------------------------------------------------

STEP_CASES = {
    "moe": ("moe", dict()),
    "moe_accum2_zloss": ("moe", dict(grad_accum_steps=2, z_loss_coef=1e-3)),
    "moe_fused": ("moe", dict(fused_ce_chunks=4)),
    "v2": ("v2", dict()),
    "v3": ("v3", dict()),
}


def _check_step(m, jm, i):
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   err_msg=f"{key}, step {i}")


def _check_leaves(params, jparams, i, atol=1e-4):
    want = sorted_jax_leaves(jparams)
    got = _leaves(params)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        np.testing.assert_allclose(
            g.detach().float().numpy(), np.asarray(w), atol=atol, rtol=0,
            err_msg=f"{jax.tree_util.keystr(path)}, step {i}")


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_train_steps_match_jax(case):
    shape, kw = STEP_CASES[case]
    jcfg = jax_cfg(shape)
    tree = numpy_tree(jcfg)
    accum = kw.get("grad_accum_steps", 1)
    tkw = dict(learning_rate=1e-2, warmup_steps=1, steps=3,
               batch_size=2 * accum, seq_len=S, **kw)
    jtc = jtrain.TrainConfig(**tkw)
    jopt = jtrain.make_optimizer(jtc)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jtrain.make_train_step(
        jllama.LlamaModel(jcfg), jopt, donate=False, grad_accum_steps=accum,
        z_loss_coef=jtc.z_loss_coef, fused_ce_chunks=jtc.fused_ce_chunks)
    cfg = config_from_jax(jcfg, torch.float32)
    trainer = Trainer(cfg, TrainConfig(**tkw), device="cpu",
                      initial_params=params_from_jax(tree, cfg, "cpu",
                                                     master=True))
    data = batches(3, jcfg.vocab_size, b=2 * accum)
    if shape == "v3":
        names = sorted(jax.tree_util.keystr(p) for p, _ in
                       jax.tree_util.tree_flatten_with_path(jparams)[0])
        at = names.index("['layers']['router_bias']")
        _, _, grads = loss_aux_and_grads(trainer.model, trainer.params,
                                         torch.from_numpy(data[0]))
        assert grads[at].shape == (2, 8) and not grads[at].any()
    for i, batch in enumerate(data):
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(batch))
        m = trainer.step_fn(trainer.params, trainer.opt_state,
                            torch.from_numpy(batch))
        _check_step(m, jm, i)
        if shape != "v3":
            assert float(m["aux_loss"]) > 0.0
        _check_leaves(trainer.params, jparams, i)
    if shape == "v3":
        # decayed with every leaf, as optax decays it
        bias = trainer.params["layers"]["router_bias"]
        assert not torch.equal(bias, torch.from_numpy(
            tree["layers"]["router_bias"]))


# -- (4) LoRA over an MoE base ---------------------------------------------------------

@pytest.mark.parametrize("shape,targets", [("moe", ("wq", "wv")),
                                           ("v2", ("wq", "wo"))])
def test_lora_steps_match_jax_with_experts_and_prefix_frozen(shape, targets):
    jcfg = jax_cfg(shape)
    tree = numpy_tree(jcfg)
    kw = dict(learning_rate=1e-2, warmup_steps=1, steps=2, batch_size=B,
              seq_len=S)
    jtr = jtrain.Trainer(jcfg, jtrain.TrainConfig(**kw), initial_params=tree,
                         lora=jlora.LoraConfig(rank=4, alpha=8.0,
                                               targets=targets))
    cfg = config_from_jax(jcfg, torch.float32)
    ptr = Trainer(cfg, TrainConfig(**kw), device="cpu",
                  initial_params=params_from_jax(tree, cfg, "cpu",
                                                 master=True),
                  lora=plora.LoraConfig(rank=4, alpha=8.0, targets=targets))
    with torch.no_grad():
        for t in targets:
            ptr.params["layers"][t]["lora_a"].copy_(torch.from_numpy(
                np.array(jtr.params["layers"][t]["lora_a"])))
    frozen = {n: p.clone() for n, p in ptr.params["layers"].items()
              if not isinstance(p, dict)}
    prefix = {n: p.clone() for n, p in ptr.params.get("prefix_layers",
                                                       {}).items()}
    assert (prefix != {}) == (shape == "v2")
    for i, batch in enumerate(batches(2, jcfg.vocab_size)):
        jtr.params, jtr.opt_state, jm = jtr.step_fn(
            jtr.params, jtr.opt_state, jnp.asarray(batch))
        m = ptr.step_fn(ptr.params, ptr.opt_state, torch.from_numpy(batch))
        _check_step(m, jm, i)
        assert float(m["aux_loss"]) > 0.0
    _check_leaves(ptr.params, jtr.params, 1)
    for t in targets:
        assert ptr.params["layers"][t]["lora_b"].abs().max() > 0
    for n, p in frozen.items():
        assert torch.equal(ptr.params["layers"][n], p), n
    for n, p in prefix.items():
        assert torch.equal(ptr.params["prefix_layers"][n], p), n
    assert "router" in frozen and "we_down" in frozen
    assert set(_leaves(trainable(ptr.params, ptr.trainable_mask))) \
        .isdisjoint(set(_leaves({"f": frozen})))


def test_lora_refuses_wv_on_mla_as_jax_does():
    jcfg = jax_cfg("v2")
    cfg = config_from_jax(jcfg, torch.float32)
    lc = dict(rank=4, targets=("wq", "wv"))
    with pytest.raises(ValueError) as jerr:
        jlora.apply_lora(jcfg, numpy_tree(jcfg), jlora.LoraConfig(**lc),
                         jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as perr:
        Trainer(cfg, TrainConfig(batch_size=B, seq_len=S), device="cpu",
                lora=plora.LoraConfig(**lc))
    assert str(perr.value) == str(jerr.value)
    assert "'wv' not in this model" in str(perr.value)


# -- (5) the in-process seq mesh -----------------------------------------------------

def test_seq_mesh_step_equals_the_unsharded_step():
    jcfg = jax_cfg("moe")
    tree = numpy_tree(jcfg)
    cfg = config_from_jax(jcfg, torch.float32)
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=2,
                     batch_size=B, seq_len=S)
    runs = []
    for mesh in (None, make_mesh(MeshConfig(seq=2))):
        tr = Trainer(cfg, tc, device="cpu", mesh=mesh,
                     initial_params=params_from_jax(tree, cfg, "cpu",
                                                    master=True))
        runs.append((tr, [tr.step_fn(tr.params, tr.opt_state,
                                     torch.from_numpy(b))
                          for b in batches(2, jcfg.vocab_size)]))
    (plain, pm), (ring, rm) = runs
    for i, (a, b) in enumerate(zip(rm, pm)):
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(a[key]), float(b[key]),
                                       rtol=1e-5, err_msg=f"{key}, {i}")
    for a, b in zip(_leaves(ring.params), _leaves(plain.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, rtol=0)


# -- (6) checkpoints and the CLI -------------------------------------------------------

def test_restore_gives_the_same_next_loss_and_aux(tmp_path):
    cfg = config_from_jax(jax_cfg("v2"), torch.float32)
    tree = numpy_tree(jax_cfg("v2"))
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=4,
                     batch_size=B, seq_len=S, checkpoint_dir=str(tmp_path))
    data = batches(3, cfg.vocab_size)

    def trainer():
        return Trainer(cfg, tc, device="cpu",
                       initial_params=params_from_jax(tree, cfg, "cpu",
                                                      master=True))

    first = trainer()
    for b in data[:2]:
        first.step_fn(first.params, first.opt_state, torch.from_numpy(b))
        first.step += 1
    first.save()
    want = first.step_fn(first.params, first.opt_state,
                         torch.from_numpy(data[2]))
    second = trainer()
    assert second.restore() and second.step == 2
    got = second.step_fn(second.params, second.opt_state,
                         torch.from_numpy(data[2]))
    for key in ("loss", "aux_loss", "grad_norm"):
        assert float(got[key]) == float(want[key]), key


def test_train_main_tiny_moe_prints_its_summary_and_resumes(tmp_path,
                                                            capsys, caplog):
    argv = ["--device", "cpu", "--model", "tiny-moe", "--steps", "1",
            "--batch", "2", "--seq-len", "16", "--checkpoint-dir",
            str(tmp_path)]
    with caplog.at_level(logging.INFO):
        for _ in range(2):
            assert train_main.main(argv) == 0
    outs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert len(outs) == 2
    for out in outs:
        assert (out["workload"], out["model"], out["steps"]) == \
            ("pretrain", "tiny-moe", 1)
        assert np.isfinite(out["final_loss"])
    assert "resumed from checkpoint step 1" in caplog.messages
