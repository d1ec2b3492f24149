"""The port's device rung and its ladder (``fleet/device_transfer.py``) on
the CPU, beside the JAX package's module:

- placement domains detect as the JAX package's do (override, the
  environment, the slice's host-qualified domain, the process);
- the bus: URLs normalized, re-registration wins, a miss or another
  domain refuses the push;
- the shm blob: a written blob maps back byte for byte, paths outside the
  shm dir or without its prefix are refused, vanished and empty files
  downgrade, ``ShmBlobGC`` sweeps only expired blobs;
- between two engines of this process: ``device_push`` (monolithic and
  streamed) and ``device_pull`` move the run arena to arena, and the
  cold engine decodes the owner's greedy tokens; a pull of an evicted run
  is GONE;
- over the HTTP front: a ``/kv_prefill`` annotated ``device`` between two
  fronts of this process takes the device rung; one whose target is not
  on the bus and not vouched for downgrades to the wire, counted in
  ``tpu_serving_kv_handoff_device_downgrades``; a vouched target in the
  same domain takes the shm rung.
"""

from __future__ import annotations

import json
import os
import socket
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.fleet import device_transfer as jdt
from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu_torch.fleet import device_transfer as pdt
from k8s_runpod_kubelet_tpu_torch.fleet.device_transfer import (
    BUS, DeviceTransferBus, DeviceTransferError, ShmBlobGC, device_pull,
    device_push, open_shm_blob, write_shm_blob)
from k8s_runpod_kubelet_tpu_torch.fleet.handoff import KVPullMiss
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)

TIMEOUT = 120
T = 8
JCFG = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, mlp_dim=128,
                         max_seq_len=256, dtype=jnp.float32,
                         param_dtype=jnp.float32)


@pytest.fixture(autouse=True)
def _clean_bus():
    BUS.clear()
    yield
    BUS.clear()


ENVS = {
    "override": ("rack:7", {}, "auto"),
    "env": ("", {"TPU_FLEET_PLACEMENT_DOMAIN": "slice:a"}, "auto"),
    "process": ("", {}, "auto"),
    "slice": ("", {"TPU_SLICE_NAME": "pod-3"}, "auto"),
    "proc_mode": ("", {"TPU_SLICE_NAME": "pod-3"}, "proc"),
    "slice_mode_unset": ("", {}, "slice"),
    "override_beats_slice": ("rack:1", {"TPU_SLICE_NAME": "pod-3"}, "slice"),
}


@pytest.mark.parametrize("case", sorted(ENVS))
def test_placement_domains_detect_as_the_jax_package(case):
    override, env, mode = ENVS[case]
    got = pdt.detect_placement_domain(override, env=env, mode=mode)
    assert got == jdt.detect_placement_domain(override, env=env, mode=mode)
    if case == "process":
        assert got == f"proc:{socket.gethostname()}:{os.getpid()}"


def test_the_bus_registers_and_refuses():
    bus = DeviceTransferBus()
    bus.register("http://r:1/", "engine-a", "d")
    assert bus.lookup("http://r:1") == ("engine-a", "d")
    bus.register("http://r:1", "engine-b", "d")
    assert bus.lookup("http://r:1/") == ("engine-b", "d")
    with pytest.raises(ValueError):
        bus.register("", "engine", "d")
    with pytest.raises(ValueError):
        bus.register("http://r:2", "engine", "")
    bus.unregister("http://r:1")
    assert bus.lookup("http://r:1") is None
    with pytest.raises(DeviceTransferError, match="bus miss"):
        device_push(None, "http://r:1", [1], domain="d", bus=bus)
    bus.register("http://r:1", "engine-a", "other")
    with pytest.raises(DeviceTransferError, match="placement-domain"):
        device_push(None, "http://r:1", [1], domain="d", bus=bus)


def test_shm_blobs_map_back_and_refuse_foreign_paths(tmp_path):
    blob = os.urandom(4096)
    path = write_shm_blob(blob, dir=str(tmp_path))
    assert os.path.basename(path).startswith("tpukv-")
    m = open_shm_blob(path, dir=str(tmp_path))
    try:
        assert bytes(m) == blob
    finally:
        m.close()
    outside = tmp_path / "sub"
    outside.mkdir()
    other = outside / "tpukv-x.kv"
    other.write_bytes(b"x")
    for bad in (str(other), str(tmp_path / "notkv.kv"), "/etc/passwd", ""):
        with pytest.raises(DeviceTransferError):
            open_shm_blob(bad, dir=str(tmp_path))
    empty = write_shm_blob(b"", dir=str(tmp_path))
    with pytest.raises(DeviceTransferError, match="cannot map"):
        open_shm_blob(empty, dir=str(tmp_path))
    os.unlink(empty)
    os.unlink(path)
    with pytest.raises(DeviceTransferError, match="cannot map"):
        open_shm_blob(path, dir=str(tmp_path))


def test_the_gc_sweeps_expired_blobs_only(tmp_path):
    now = [0.0]
    gc = ShmBlobGC(ttl_s=10.0, clock=lambda: now[0])
    old = write_shm_blob(b"a", dir=str(tmp_path))
    gc.track(old)
    gone = write_shm_blob(b"c", dir=str(tmp_path))
    gc.track(gone)
    os.unlink(gone)            # the puller's unlink: no leak, no error
    now[0] = 5.0
    young = write_shm_blob(b"b", dir=str(tmp_path))
    gc.track(young)
    now[0] = 12.0
    assert gc.sweep() == 1 and len(gc) == 1
    assert not os.path.exists(old) and os.path.exists(young)
    with pytest.raises(ValueError):
        ShmBlobGC(ttl_s=0)
    os.unlink(young)


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(3)))


def _engine(tree, **kw) -> ServingEngine:
    cfg = config_from_jax(JCFG, torch.float32)
    sc = dict(slots=2, max_prefill_len=32, cache_len=128, max_new_tokens=8,
              kv_page_tokens=T)
    sc.update(kw)
    return ServingEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                         ServingConfig(**sc), device="cpu").start()


def _prompt(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, 128, 37)]


def _tokens(engine, prompt) -> list:
    return engine.submit(prompt).result(timeout=TIMEOUT)["tokens"]


@pytest.mark.parametrize("chunk", [0, T], ids=["monolithic", "streamed"])
def test_device_push_and_pull_between_two_engines(tree, chunk):
    owner, cold = _engine(tree, serving_chunk_tokens=chunk), _engine(tree)
    try:
        bus = DeviceTransferBus()
        bus.register("http://owner", owner, "proc:t")
        bus.register("http://cold", cold, "proc:t")
        pushed = _prompt(1)
        out = device_push(owner, "http://cold", pushed, domain="proc:t",
                          bus=bus, window=2)
        assert out["path"] == "device" and out["streamed"] == bool(chunk)
        assert out["adopted"] == len(pushed) // T
        # a run the owner served itself, pulled by the cold engine
        pulled = _prompt(2)
        want = _tokens(owner, pulled)
        out = device_pull(cold, "http://owner", pulled, domain="proc:t",
                          bus=bus)
        assert (out["path"], out["pages"]) == ("device", len(pulled) // T)
        assert cold.metrics.get_counter("tpu_serving_kv_handoff_device_runs") \
            == 2
        assert owner.metrics.get_counter("tpu_serving_kv_pull_runs") == 1
        chunks0 = cold.counters["paged_prefill_chunks"]
        # pushed: both engines decode from the cached pages
        assert _tokens(cold, pushed) == _tokens(owner, pushed)
        assert cold.counters["paged_prefill_chunks"] - chunks0 == 1
        # pulled: the owner's first answer came from a full prefill; the
        # cold engine's from the pages plus the tail, to the same tokens
        # on this f32 model
        assert _tokens(cold, pulled) == want
        with pytest.raises(KVPullMiss):
            device_pull(cold, "http://owner", _prompt(3), domain="proc:t",
                        bus=bus)
        with pytest.raises(DeviceTransferError, match="placement-domain"):
            device_pull(cold, "http://owner", pulled, domain="proc:u",
                        bus=bus)
    finally:
        owner.stop()
        cold.stop()


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_kv_prefill_walks_the_ladder_and_counts_downgrades(tree):
    pre, dec = _engine(tree), _engine(tree)
    fronts = [serve_main.serve(e, 0, host="127.0.0.1",
                               device_domain="proc:t") for e in (pre, dec)]
    ports = [f.server_address[1] for f in fronts]
    url = f"http://127.0.0.1:{ports[1]}"
    try:
        def hop(prompt, **kw):
            return _post(ports[0], "/kv_prefill",
                         {"request": {"tokens": prompt}, "handoff_to": url,
                          **kw})

        # no bus entry, no vouched domain: the device rung downgrades
        out = hop(_prompt(1), device=True)
        assert (out["ok"], out["path"]) == (True, "wire")
        assert pre.metrics.get_counter(
            "tpu_serving_kv_handoff_device_downgrades") == 1
        # the router vouches for the domain: the shm rung
        out = hop(_prompt(2), device=True, device_domain="proc:t")
        assert (out["ok"], out["path"]) == (True, "shm")
        # the decode engine on this process's bus: the device rung
        BUS.register(url, dec, "proc:t")
        out = hop(_prompt(3), device=True)
        assert (out["ok"], out["path"], out["streamed"]) == \
            (True, "device", False)
        assert pre.metrics.get_counter(
            "tpu_serving_kv_handoff_device_downgrades") == 1
        assert dec.metrics.get_counter("tpu_serving_kv_handoff_pages") == \
            3 * (37 // T)
        # the quiet skip of a prompt under one page
        assert hop([1, 2, 3]) == {"ok": False, "skip": True,
                                  "error": "prompt of 3 tokens is under "
                                           "one 8-token page"}
        for p in (1, 2, 3):
            assert _tokens(dec, _prompt(p)) == _tokens(pre, _prompt(p))
    finally:
        for f in fronts:
            f.shutdown()
            f.server_close()
        pre.stop()
        dec.stop()
