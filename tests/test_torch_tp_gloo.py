"""The process-group form of the port's tensor parallelism on gloo, against
its in-process form, on the CPU in f32.

Each case spawns 2 processes (``torch.distributed`` over gloo, one
tensor shard a rank, meeting through a file store in the test's temporary
directory: a port picked free and released could be taken by another
process before rank 0 bound it), joined with a timeout so that a hung
rank fails the test instead of stalling the run; every process is stopped,
and a rank that fails fails the test. Each rank holds its own slice of
the weights (``parallel.shard_params`` over the group) and of the arena's
kv heads:

- ``int4_matmul_sharded``: the 2-D int4 product on the rank's out-slice,
  then the ranks' slices all-gathered, against the in-process form on the
  same weights: equal;
- one ``paged_verify_step`` a rank (a prefill chunk, then a verify over it)
  of an f32 ``tiny_llama`` with f32 weights over a head-sharded f32 arena,
  int4 weights over a head-sharded int8 arena, and f32 weights over a
  replicated arena: every rank's logits against the in-process step's
  within 1e-5 (the same products as GEMMs of other shapes and the psum's
  sums in another order), and the rank's arena heads equal to its shard of
  the in-process arena.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.ops import int4_matmul_sharded
from k8s_runpod_kubelet_tpu_torch.parallel import (MeshConfig, make_mesh,
                                                   shard_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
# (weight bits, int8 arena, shard the arena's heads)
STEP_CASES = [(None, False, True), (4, True, True), (None, False, False)]

_SETUP = textwrap.dedent('''
    import numpy as np
    import torch

    from k8s_runpod_kubelet_tpu_torch.models import (LlamaModel,
                                                     init_params, tiny_llama)
    from k8s_runpod_kubelet_tpu_torch.models.quant import quantize_params
    from k8s_runpod_kubelet_tpu_torch.parallel import shard_params

    CFG = tiny_llama(vocab_size=128, embed_dim=256, n_layers=2, n_heads=8,
                     n_kv_heads=4, mlp_dim=256, max_seq_len=128,
                     dtype=torch.float32)
    PAGES, T = 16, 8


    def tree(bits):
        params = init_params(CFG, torch.Generator().manual_seed(2), "cpu")
        return params if bits is None else quantize_params(CFG, params, bits)


    def steps(model, params, arena, data):
        """A 20-token chunk, then a 3-token verify over it."""
        table, out = torch.from_numpy(data["table"]), []
        lengths = torch.zeros(2, dtype=torch.int32)
        for toks, n_tok in ((data["chunk"], [20, 13]), (data["verify"],
                                                       [3, 2])):
            n_tok = torch.tensor(n_tok, dtype=torch.int32)
            logits, arena = model.paged_verify_step(
                params, torch.from_numpy(toks), arena, table, lengths,
                n_tokens=n_tok)
            out.append(logits.numpy())
            lengths = lengths + n_tok
        return out, arena
''')

_WORKER = _SETUP + textwrap.dedent('''
    import sys
    import torch.distributed as dist

    rank, n, base = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    # the rendezvous is a file store beside the inputs: no port to claim
    dist.init_process_group("gloo", init_method=f"file://{base}.store",
                            world_size=n, rank=rank)
    from k8s_runpod_kubelet_tpu_torch.ops import int4_matmul_sharded
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(tensor=n), group=dist.group.WORLD)
    assert mesh.rank == rank and not mesh.in_process
    data = np.load(base + ".in.npz")
    res = {}
    q4, scale = (torch.from_numpy(data[x]) for x in ("q4", "scale"))
    o = q4.shape[1] // n
    res["int4"] = int4_matmul_sharded(
        torch.from_numpy(data["h"]), q4[:, rank * o:(rank + 1) * o]
        .contiguous(), scale[..., rank * o:(rank + 1) * o].contiguous(),
        mesh).numpy()
    for bits, kv_int8, shard_kv in CASES:
        model = LlamaModel(CFG, "cpu", mesh)
        params = shard_params(CFG, tree(bits), mesh)
        arena = model.init_paged_arena(PAGES, T, quantize=kv_int8,
                                       shard_kv=shard_kv)
        out, arena = steps(model, params, arena, data)
        key = f"{bits}_{kv_int8}_{shard_kv}"
        res[key + "_chunk"], res[key + "_verify"] = out
        res[key + "_k"] = arena["k"].numpy()
    np.savez(f"{base}{rank}.npz", **res)
    dist.destroy_process_group()
''')


def _run_ranks(n, tmp_path, inputs, timeout=180):
    """Each rank's results, from n spawned processes on gloo; a rank that
    fails or does not finish in ``timeout`` seconds fails the test, and
    every process is stopped."""
    base = str(tmp_path / "tp")
    np.savez(base + ".in.npz", **inputs)
    code = f"CASES = {STEP_CASES!r}\n" + _WORKER
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(n), base],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
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


def test_process_group_form_equals_the_in_process_form(tmp_path):
    from k8s_runpod_kubelet_tpu_torch.models.quant import _quantize_leaf_int4

    rng = np.random.default_rng(31)
    leaf = _quantize_leaf_int4(torch.from_numpy(
        (0.05 * rng.normal(size=(512, 256))).astype(np.float32)))
    inputs = dict(h=rng.normal(size=(5, 512)).astype(np.float32),
                  q4=leaf["q4"].numpy(), scale=leaf["scale"].numpy(),
                  table=rng.permutation(16)[:8].reshape(2, 4)
                  .astype(np.int32),
                  chunk=rng.integers(1, 128, (2, 20)).astype(np.int32),
                  verify=rng.integers(1, 128, (2, 3)).astype(np.int32))
    ranks = _run_ranks(RANKS, tmp_path, inputs)

    mesh = make_mesh(MeshConfig(tensor=RANKS))
    q4 = leaf["q4"].unflatten(1, (RANKS, -1)).movedim(1, 0).contiguous()
    scale = leaf["scale"].unflatten(2, (RANKS, -1)).movedim(2, 0) \
        .contiguous()
    want = int4_matmul_sharded(torch.from_numpy(inputs["h"]), q4, scale,
                               mesh).numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["int4"], want)

    scope: dict = {}
    exec(_SETUP, scope)
    cfg = scope["CFG"]
    for bits, kv_int8, shard_kv in STEP_CASES:
        model = LlamaModel(cfg, "cpu", mesh)
        params = shard_params(cfg, scope["tree"](bits), mesh)
        arena = model.init_paged_arena(scope["PAGES"], scope["T"],
                                       quantize=kv_int8, shard_kv=shard_kv)
        want, arena = scope["steps"](model, params, arena, inputs)
        key = f"{bits}_{kv_int8}_{shard_kv}"
        heads = (arena["k"].unflatten(0, (RANKS, cfg.n_layers)).numpy()
                 if shard_kv else None)
        for rank, r in enumerate(ranks):
            for i, step in enumerate(("chunk", "verify")):
                n_tok = ([20, 13], [3, 2])[i]
                for b in range(2):
                    np.testing.assert_allclose(
                        r[f"{key}_{step}"][b, :n_tok[b]],
                        want[i][b, :n_tok[b]], atol=1e-5, rtol=0,
                        err_msg=f"{key} {step} rank {rank}")
            if shard_kv:
                np.testing.assert_allclose(r[key + "_k"], heads[rank],
                                           atol=1e-5, rtol=0)
            else:
                np.testing.assert_allclose(r[key + "_k"],
                                           arena["k"].numpy(), atol=1e-5,
                                           rtol=0)
