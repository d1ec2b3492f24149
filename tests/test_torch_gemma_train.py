"""Training Gemma 2 and Gemma 3 in the port against the JAX package's
trainer, on the CPU in f32.

The JAX tests' tiny configs (``tests/test_models_train.py``
``GEMMA2_CFG``/``GEMMA3_CFG``: vocab 128, E 64, 4 heads over 2 kv heads
of 32, window 8 at a 1:1 and a 5:1 local/global interleave over 32-token
sequences, so the window masks; Gemma 2's attention cap 50 and final cap
30, the query scalar, sandwich norms, GeGLU, a tied table scaled by √E;
Gemma 3's q/k norm, local RoPE base and linear ×2 global scaling), their
parameters drawn from a seed with numpy into the JAX layout (norms away
from identity) and carried over by ``params_from_jax``. Checked:

- three ``Trainer.step_fn`` AdamW steps against the JAX
  ``make_train_step`` on the same batches (``warmup_steps=1``, lr 1e-2):
  loss within 1e-5 relative, ``grad_norm`` within 1e-5, every leaf within
  1e-4 after every step, the port under remat none, "full" and "dots"
  (the JAX reference's numbers do not depend on remat), and with
  ``fused_ce_chunks`` 4 under Gemma 2's final cap 30 (the same function
  as the naive loss: held to the same JAX steps);
- LoRA r4 over all seven targets of Gemma 2 against the JAX
  ``Trainer(lora=)`` (A copied from the JAX draw): two steps, every leaf
  within 1e-4, the frozen base (the tied table included) bit-identical;
  Gemma 3's trained adapters merged as the JAX ``merge_lora`` merges them,
  the tied table untouched, the merged logits the wrapped model's, and
  ``extract_adapter`` over the seven;
- Gemma 2 on the in-process ``seq`` = 2 mesh (local sublayers band-mask
  and truncate the ring, global ones ring the whole context; plain ring
  and ring flash) equal to its unsharded step, the JAX
  ``test_gemma2_interleave_trains_on_seq_axis``'s port;
- save, restore into a new trainer, the same next loss;
- ``train_main`` over a tiny Gemma 2 entry (the registry monkeypatched)
  with ``--lora-rank 4`` on all seven targets, ``--fused-ce-chunks``,
  ``--seq 2`` (ring flash) and ``--export-adapter``: the file it writes is
  accepted by ``POST /adapters`` of a contiguous-loop server over the same
  base, and the adapter serves.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.models import lora as jlora
from k8s_runpod_kubelet_tpu.workloads import train as jtrain
from k8s_runpod_kubelet_tpu_torch.models import lora as plora
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main, train_main
from k8s_runpod_kubelet_tpu_torch.workloads.train import (TrainConfig,
                                                          Trainer, _leaves)

B, S = 2, 32
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
GEMMA = dict(vocab_size=128, embed_dim=64, n_heads=4, n_kv_heads=2,
             head_dim=32, mlp_dim=128, max_seq_len=128,
             tie_embeddings=True, mlp_activation="gelu_tanh",
             embed_scale=True, norm_zero_centered=True, post_norms=True,
             sliding_window=8, dtype=jnp.float32, param_dtype=jnp.float32)
JCFGS = {
    "g2": jllama.tiny_llama(**GEMMA, name="tiny-gemma2", n_layers=4,
                            rope_theta=10_000.0, logit_softcap=30.0,
                            attn_logit_softcap=50.0,
                            query_pre_attn_scalar=64.0,
                            sliding_window_pattern=2),
    "g3": jllama.tiny_llama(**GEMMA, name="tiny-gemma3", n_layers=6,
                            rope_theta=100_000.0, rope_local_theta=10_000.0,
                            rope_scaling={"rope_type": "linear",
                                          "factor": 2.0},
                            query_pre_attn_scalar=32.0, qk_norm=True,
                            sliding_window_pattern=6),
}
TKW = dict(learning_rate=1e-2, warmup_steps=1, steps=3, batch_size=B,
           seq_len=S)


def numpy_tree(jcfg, seed: int = 20261025):
    """Seeded numpy parameters in the JAX layout: zero-centered norms at
    0.1 N(0, 1) (applied as 1 + w), the rest 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jax_init_params(jcfg, jax.random.PRNGKey(0))))

    def leaf(path, shape):
        if str(path[-1].key).endswith("norm"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def batches(n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, (B, S + 1)).astype(np.int32)
            for _ in range(n)]


def sorted_jax_leaves(tree):
    """(path, leaf) of a JAX tree in the port's ``_leaves`` order."""
    return sorted(jax.tree_util.tree_flatten_with_path(tree)[0],
                  key=lambda kv: [str(k.key) for k in kv[0]])


def _check_leaves(params, jleaves, what, atol=1e-4):
    got = _leaves(params)
    assert len(got) == len(jleaves)
    for (path, w), g in zip(jleaves, got):
        np.testing.assert_allclose(
            g.detach().float().numpy(), np.asarray(w), atol=atol, rtol=0,
            err_msg=f"{jax.tree_util.keystr(path)}, {what}")


def _port_trainer(name, tree, mesh=None, **kw):
    cfg = config_from_jax(JCFGS[name], torch.float32)
    cfg = dataclasses.replace(cfg, **kw.pop("cfg", {}))
    return Trainer(cfg, TrainConfig(**{**TKW, **kw}), device="cpu",
                   mesh=mesh, initial_params=params_from_jax(
                       tree, cfg, "cpu", master=True))


_JAX_RUNS: dict = {}


def jax_run(name: str):
    """(numpy tree, [(metrics, sorted leaves) after each step]) of three
    JAX steps, computed once per config."""
    key = name
    if key not in _JAX_RUNS:
        jcfg = JCFGS[name]
        tree = numpy_tree(jcfg)
        jopt = jtrain.make_optimizer(jtrain.TrainConfig(**TKW))
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        jstate = jopt.init(jparams)
        jstep = jtrain.make_train_step(jllama.LlamaModel(jcfg), jopt,
                                       donate=False)
        steps = []
        for batch in batches(3):
            jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(batch))
            steps.append(({k: float(jm[k]) for k in ("loss", "grad_norm")},
                          [(p, np.asarray(w))
                           for p, w in sorted_jax_leaves(jparams)]))
        _JAX_RUNS[key] = (tree, steps)
    return _JAX_RUNS[key]


CASES = {f"{name}-{pol}": (name, pol, 0)
         for name in sorted(JCFGS) for pol in ("none", "full", "dots")}
# the fused loss is the naive one's function: held to the same JAX run
CASES["g2-fused-cap"] = ("g2", "dots", 4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_train_steps_match_jax(case):
    name, policy, fused = CASES[case]
    tree, want = jax_run(name)
    tr = _port_trainer(name, tree, fused_ce_chunks=fused,
                       cfg=dict(remat=policy != "none",
                                remat_policy=policy))
    assert tr.model.cfg.remat_policy == policy
    if name == "g2":
        assert tr.model.cfg.logit_softcap == 30.0
    for i, (batch, (jm, jleaves)) in enumerate(zip(batches(3), want)):
        m = tr.step_fn(tr.params, tr.opt_state, torch.from_numpy(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-5,
                                       err_msg=f"{key}, step {i}")
        _check_leaves(tr.params, jleaves, f"step {i}")


@pytest.mark.parametrize("name", ["g2"])
def test_lora_on_all_seven_targets_matches_jax_with_the_base_frozen(name):
    jcfg = JCFGS[name]
    tree = numpy_tree(jcfg)
    kw = dict(TKW, steps=2)
    jtr = jtrain.Trainer(jcfg, jtrain.TrainConfig(**kw), initial_params=tree,
                         lora=jlora.LoraConfig(rank=4, alpha=8.0,
                                               targets=TARGETS))
    cfg = config_from_jax(jcfg, torch.float32)
    ptr = Trainer(cfg, TrainConfig(**kw), device="cpu",
                  initial_params=params_from_jax(tree, cfg, "cpu",
                                                 master=True),
                  lora=plora.LoraConfig(rank=4, alpha=8.0, targets=TARGETS))
    with torch.no_grad():
        for t in TARGETS:
            ptr.params["layers"][t]["lora_a"].copy_(torch.from_numpy(
                np.array(jtr.params["layers"][t]["lora_a"])))
    frozen = [p.clone() for p in _leaves(ptr.params)
              if not p.requires_grad]
    for i, batch in enumerate(batches(2)):
        jtr.params, jtr.opt_state, jm = jtr.step_fn(
            jtr.params, jtr.opt_state, jnp.asarray(batch))
        m = ptr.step_fn(ptr.params, ptr.opt_state, torch.from_numpy(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
    _check_leaves(ptr.params, sorted_jax_leaves(jtr.params), "after 2")
    for t in TARGETS:
        assert ptr.params["layers"][t]["lora_b"].abs().max() > 0, t
    now = [p for p in _leaves(ptr.params) if not p.requires_grad]
    assert len(now) == len(frozen) and any(
        p.shape == (128, 64) for p in now)         # the tied table
    for a, b in zip(now, frozen):
        assert torch.equal(a, b)


def test_merge_and_extract_over_the_tied_table_match_jax():
    """Gemma 3 LoRA-trained on all seven targets: ``merge_lora`` equals the
    JAX ``merge_lora`` of the same tree, leaves the tied table alone, and
    the merged model's logits are the wrapped model's; ``extract_adapter``
    holds the seven trained adapters."""
    cfg = config_from_jax(JCFGS["g3"], torch.float32)
    tr = Trainer(cfg, TrainConfig(**dict(TKW, steps=2)), device="cpu",
                 initial_params=params_from_jax(numpy_tree(JCFGS["g3"]), cfg,
                                                "cpu", master=True),
                 lora=plora.LoraConfig(rank=4, alpha=8.0, targets=TARGETS))
    for b in batches(2):
        tr.step_fn(tr.params, tr.opt_state, torch.from_numpy(b))
    params = jax.tree_util.tree_map(lambda p: p.detach(), tr.params)
    merged = plora.merge_lora(params)
    want = jlora.merge_lora(jax.tree_util.tree_map(
        lambda p: jnp.asarray(p.numpy()), params))
    for (path, w), g in zip(sorted_jax_leaves(want), _leaves(merged)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))
    assert merged["tok_embed"] is params["tok_embed"]
    tokens = torch.from_numpy(batches(1)[0][:, :-1])
    np.testing.assert_allclose(
        tr.model.forward(merged, tokens).numpy(),
        tr.model.forward(params, tokens).numpy(), atol=1e-5, rtol=0)
    ad = plora.extract_adapter(params)
    assert sorted(ad) == sorted(TARGETS)
    assert all(a["b"].abs().max() > 0 for a in ad.values())


@pytest.mark.parametrize("ring_flash", [False, True],
                         ids=["plain_ring", "ring_flash"])
def test_gemma2_on_the_seq_mesh_equals_the_unsharded_step(ring_flash):
    tree = numpy_tree(JCFGS["g2"])
    runs = []
    for mesh in (None, make_mesh(MeshConfig(seq=2))):
        tr = _port_trainer("g2", tree, mesh=mesh,
                           cfg=dict(ring_flash=ring_flash), steps=2)
        runs.append((tr, [tr.step_fn(tr.params, tr.opt_state,
                                     torch.from_numpy(b))
                          for b in batches(2)]))
    (plain, pm), (ring, rm) = runs
    for i, (a, b) in enumerate(zip(rm, pm)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(a[key]), float(b[key]),
                                       rtol=1e-5, err_msg=f"{key}, {i}")
    for a, b in zip(_leaves(ring.params), _leaves(plain.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, rtol=0)


def test_restore_gives_the_same_next_loss(tmp_path):
    tree = numpy_tree(JCFGS["g3"])
    data = batches(3)
    first = _port_trainer("g3", tree, checkpoint_dir=str(tmp_path))
    for b in data[:2]:
        first.step_fn(first.params, first.opt_state, torch.from_numpy(b))
        first.step += 1
    first.save()
    want = first.step_fn(first.params, first.opt_state,
                         torch.from_numpy(data[2]))
    second = _port_trainer("g3", tree, checkpoint_dir=str(tmp_path))
    assert second.restore() and second.step == 2
    got = second.step_fn(second.params, second.opt_state,
                         torch.from_numpy(data[2]))
    for key in ("loss", "grad_norm"):
        assert float(got[key]) == float(want[key]), key


def test_train_main_exports_an_adapter_the_contiguous_server_takes(
        tmp_path, monkeypatch, capsys):
    from k8s_runpod_kubelet_tpu_torch import models

    cfg = dataclasses.replace(config_from_jax(JCFGS["g2"], torch.float32),
                              vocab_size=260, max_seq_len=256)
    monkeypatch.setitem(models.MODEL_CONFIGS, "tiny-gemma2", lambda: cfg)
    path = str(tmp_path / "ft.npz")
    assert train_main.main(
        ["--device", "cpu", "--model", "tiny-gemma2", "--steps", "2",
         "--batch", "2", "--seq-len", "32", "--lora-rank", "4",
         "--lora-targets", ",".join(TARGETS), "--fused-ce-chunks", "4",
         "--seq", "2", "--export-adapter", path]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "tiny-gemma2" and np.isfinite(out["final_loss"])
    ad = plora.load_adapter(path)
    assert sorted(ad) == sorted(TARGETS)
    assert ad["wq"]["a"].shape == (4, 64, 4) and np.abs(
        ad["w_down"]["b"]).max() > 0
    args = serve_main.parse_args(
        ["--device", "cpu", "--model", "tiny-gemma2", "--tokenizer", "bytes",
         "--slots", "2", "--cache-len", "256", "--max-new-tokens", "4",
         "--lora-rank", "4", "--lora-targets", ",".join(TARGETS),
         "--dynamic-adapters"])
    engine, tok = serve_main.build_engine(args)
    httpd = serve_main.serve(engine, port=0, tokenizer=tok,
                             host="127.0.0.1", allow_adapters=True)
    port = httpd.server_address[1]

    def post(route, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        assert not engine._paged_loop
        assert post("/adapters", {"name": "ft", "path": path})[0] == 200
        prompt = list(range(1, 20))
        base = post("/generate", {"tokens": prompt})[1]["tokens"]
        code, tuned = post("/generate", {"tokens": prompt, "adapter": "ft"})
        assert code == 200 and len(tuned["tokens"]) == len(base) == 4
        assert engine.adapter_names == ("ft",)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
