"""The process-group form of the port's ring attention on gloo, against
its in-process form (``ops/ring_attention.py``), on the CPU in f32.

Each case spawns 2 or 4 processes (``torch.distributed`` over gloo,
one sequence shard a rank, meeting through a file store in the test's
temporary directory rather than a localhost port another process could
take), joined with a timeout so that a hung rank fails the test instead
of stalling the run, and every process is stopped. Both schedules (the plain online-softmax ring and the flash
ring through the kernels' plain versions), forward and gradients, with a
window whose truncated ring needs the final ``hops`` (4 ranks: 2 steps of
4, hops 3); and the model's forward over a process group (each rank its
token shard, RoPE positions from rank * S) against its in-process
forward.

Tolerances: the ring, exactly equal (the same chunks, kernels and sums in
the same order on every rank); the model's logits atol 1e-5 (the same
layers over the whole batch in one process and over shards across
processes: GEMMs of other shapes).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch

from k8s_runpod_kubelet_tpu_torch.ops.ring_attention import (_ring_steps,
                                                             ring_attention)
from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _in_process(n, inputs, **kw):
    q, k, v, g = (inputs[x] for x in "qkvg")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ring_attention(tq, tk, tv, make_mesh(MeshConfig(seq=n)), **kw)
    (o * torch.from_numpy(g)).sum().backward()
    return [t.detach().numpy() for t in (o, tq.grad, tk.grad, tv.grad)]


# -- the process-group form on gloo ----------------------------------------------

GLOO_S = 64
# (use_flash, window): 20 truncates a ring of 32-position shards at 2 steps
# (2 ranks: a full ring; 4 ranks: hops = 3) and of 16-position shards at 3
GLOO_CASES = [(True, None), (True, 20), (False, None), (False, 20)]

_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, n, base = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    # the rendezvous is a file store beside the inputs: no port to claim
    dist.init_process_group("gloo", init_method=f"file://{base}.store",
                            world_size=n, rank=rank)
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel, tiny_llama
    from k8s_runpod_kubelet_tpu_torch.models import init_params
    from k8s_runpod_kubelet_tpu_torch.ops.ring_attention import (
        ring_attention)
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(seq=n), group=dist.group.WORLD)
    data = np.load(base + ".in.npz")
    s = data["q"].shape[2] // n
    rows = slice(rank * s, (rank + 1) * s)
    res = {}
    for use_flash, window in CASES:
        q, k, v = (torch.from_numpy(data[x][:, :, rows].copy())
                   .requires_grad_() for x in "qkv")
        o = ring_attention(q, k, v, mesh, sm_scale=0.25,
                           sliding_window=window, use_flash=use_flash)
        (o * torch.from_numpy(data["g"][:, :, rows].copy())).sum().backward()
        for name, t in (("o", o), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            res[f"{use_flash}_{window}_{name}"] = t.detach().numpy()
    cfg = tiny_llama(vocab_size=96, embed_dim=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, mlp_dim=96, max_seq_len=64,
                     dtype=torch.float32, ring_flash=True)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                         master=True)
    tokens = torch.from_numpy(data["tokens"])
    res["logits"] = LlamaModel(cfg, "cpu", mesh).forward(
        params, tokens[:, rank * 16:(rank + 1) * 16]).detach().numpy()
    np.savez(f"{base}{rank}.npz", **res)
    dist.destroy_process_group()
''')


def _run_ranks(n, tmp_path, inputs, timeout=120):
    """Each rank's results, from n spawned processes on gloo; a rank that
    does not finish in ``timeout`` seconds fails the test, and every
    process is stopped."""
    base = str(tmp_path / "ring")
    np.savez(base + ".in.npz", **inputs)
    code = f"CASES = {GLOO_CASES!r}\n" + _WORKER
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(n), base], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(n)]
    try:
        for r, p in enumerate(procs):
            text = p.communicate(timeout=timeout)[0].decode()
            assert p.returncode == 0, f"rank {r}:\n{text[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [np.load(f"{base}{r}.npz") for r in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_process_group_form_equals_the_in_process_form(n, tmp_path):
    rng = np.random.default_rng(20 + n)
    inputs = dict(q=_normal(rng, 1, 4, GLOO_S, 16),
                  k=_normal(rng, 1, 2, GLOO_S, 16),
                  v=_normal(rng, 1, 2, GLOO_S, 16),
                  g=_normal(rng, 1, 4, GLOO_S, 16),
                  tokens=rng.integers(0, 96, (2, 16 * n)).astype(np.int64))
    ranks = _run_ranks(n, tmp_path, inputs)
    mesh = make_mesh(MeshConfig(seq=n))
    assert (_ring_steps(n, GLOO_S // n, 20) < n) == (n == 4)
    for use_flash, window in GLOO_CASES:
        want = _in_process(n, inputs, sm_scale=0.25, sliding_window=window,
                           use_flash=use_flash)
        for name, w in zip(("o", "dq", "dk", "dv"), want):
            got = np.concatenate([r[f"{use_flash}_{window}_{name}"]
                                  for r in ranks], axis=2)
            np.testing.assert_array_equal(
                got, w, err_msg=f"{use_flash} {window} {name}")
    from k8s_runpod_kubelet_tpu_torch.models import (LlamaModel, init_params,
                                                      tiny_llama)
    cfg = tiny_llama(vocab_size=96, embed_dim=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, mlp_dim=96, max_seq_len=64,
                     dtype=torch.float32, ring_flash=True)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                         master=True)
    want = LlamaModel(cfg, "cpu", mesh).forward(
        params, torch.from_numpy(inputs["tokens"])).detach().numpy()
    got = np.concatenate([r["logits"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
