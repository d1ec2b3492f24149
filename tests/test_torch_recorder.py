"""The port's FlightRecorder against the JAX package's, on the CPU.

- the phases sum to the step wall under a fake clock;
- the ring stays within ``max_bytes`` and ``max_steps``;
- fed the same marks on the same fake clock, the port's and the JAX
  recorder's ``snapshot()`` keys, each record's keys and every number
  agree;
- ``flight_recorder=False`` leaves the engine without a recorder and
  ``debug_steps()`` says so; with it on, a served burst leaves decode and
  speculative-verify records whose phases sum to their walls, and chunk
  interleave events.
"""

import json

import pytest

import torch

from k8s_runpod_kubelet_tpu.workloads.serving import recorder as jrec
from k8s_runpod_kubelet_tpu_torch.models import init_params, tiny_llama
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.recorder import (
    PHASES, STEP_BUCKETS, FlightRecorder)

TIMEOUT = 120


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _drive(rec, clock, steps: int, spec_every: int = 3):
    """The marks an engine makes: per step schedule, kernel, sample, then
    the commit closed by step_end; a speculative step every few; an event
    between steps."""
    for i in range(steps):
        rec.step_begin()
        clock.advance(0.001 * (i % 4 + 1))
        rec.mark("schedule")
        clock.advance(0.002)
        rec.mark("kernel")
        clock.advance(0.0085 + 0.0001 * i)
        rec.mark("sample")
        clock.advance(0.0007)
        if i % spec_every == 2:
            rec.step_end(mode="spec_verify", active=3, paged=True, spec_k=4,
                         tokens=5, arena={"pages_total": 64,
                                          "pages_free": 10 + i},
                         spec={"proposed": 12, "accepted": 2,
                               "rolled_back_pages": 1})
        else:
            rec.step_end(mode="decode", active=2, paged=True, tokens=2,
                         arena={"pages_total": 64, "pages_free": 10 + i})
        if i % 5 == 4:
            clock.advance(0.0001)
            rec.event("chunk_interleave", steps=1)


def test_constants_match_the_jax_recorder():
    assert PHASES == jrec.PHASES
    assert STEP_BUCKETS == jrec.STEP_BUCKETS


def test_phases_sum_to_the_wall_under_a_fake_clock():
    clock = FakeClock()
    rec = FlightRecorder(perf=clock)
    _drive(rec, clock, 10)
    steps = [r for r in rec.records() if "wall_s" in r]
    assert len(steps) == 10
    for r in steps:
        assert set(r["phases"]) == {f"{p}_s" for p in PHASES}
        assert sum(r["phases"].values()) == pytest.approx(r["wall_s"],
                                                          abs=1e-12)
        assert r["phases"]["kernel_s"] == pytest.approx(0.002)
    # a step without marks puts the whole wall in commit
    rec.step_begin()
    clock.advance(0.004)
    rec.step_end()
    last = rec.records(1)[0]
    assert last["phases"]["commit_s"] == pytest.approx(0.004)
    assert last["wall_s"] == pytest.approx(0.004)


def test_ring_stays_within_its_bounds():
    clock = FakeClock()
    rec = FlightRecorder(max_steps=16, max_bytes=100_000, perf=clock)
    _drive(rec, clock, 60)
    assert len(rec.records()) == 16
    roll = rec.rollup()
    assert roll["records"] == 16 and roll["bytes"] == rec.ring_bytes
    small = FlightRecorder(max_steps=10_000, max_bytes=2048, perf=clock)
    _drive(small, clock, 60)
    sizes = [len(json.dumps(r, separators=(",", ":")))
             for r in small.records()]
    assert small.ring_bytes == sum(sizes) <= 2048
    assert 0 < len(sizes) < 60
    # a record larger than the whole budget is dropped, never stored
    small.event("huge", blob="x" * 4096)
    assert small.dropped_records == 1 and small.ring_bytes <= 2048
    with pytest.raises(ValueError):
        FlightRecorder(max_steps=0)
    with pytest.raises(ValueError):
        FlightRecorder(max_bytes=100)


def test_snapshot_equals_the_jax_recorders():
    c1, c2 = FakeClock(), FakeClock()
    port = FlightRecorder(max_steps=32, max_bytes=8192, perf=c1)
    ref = jrec.FlightRecorder(max_steps=32, max_bytes=8192, perf=c2)
    _drive(port, c1, 40)
    _drive(ref, c2, 40)
    got, want = port.snapshot(16), ref.snapshot(16)
    assert set(got) == set(want)
    assert set(got["rollup"]) == set(want["rollup"])
    assert len(got["steps"]) == len(want["steps"]) == 16
    for a, b in zip(got["steps"], want["steps"]):
        assert set(a) == set(b)
        for key in ("phases", "batch"):
            if key in b:
                assert set(a[key]) == set(b[key])
    # the same marks on the same clock give the same numbers
    assert got == want


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_llama(vocab_size=128, embed_dim=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, mlp_dim=64, max_seq_len=256,
                     dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(5), "cpu")


def _config(**kw):
    base = dict(slots=2, max_prefill_len=32, cache_len=128,
                max_new_tokens=8, kv_page_tokens=8)
    base.update(kw)
    return ServingConfig(**base)


def test_recorder_off_leaves_none(tiny):
    cfg, params = tiny
    eng = ServingEngine(cfg, params, _config(flight_recorder=False),
                        device="cpu")
    assert eng.recorder is None
    out = eng.debug_steps()
    assert out["enabled"] is False and "paged_step" in out["recompiles"]


def test_engine_records_its_steps(tiny):
    cfg, params = tiny
    eng = ServingEngine(cfg, params, _config(speculate_k=2,
                                             serving_chunk_tokens=8),
                        device="cpu").start()
    try:
        stream = eng.submit([5, 6, 7, 5, 6, 7, 5, 6], max_new_tokens=40)
        long_prompt = list(range(1, 49))
        sampled = eng.submit([9, 9, 9], max_new_tokens=20, temperature=0.8,
                             seed=1)
        eng.submit(long_prompt, max_new_tokens=4).result(timeout=TIMEOUT)
        stream.result(timeout=TIMEOUT)
        sampled.result(timeout=TIMEOUT)
        snap = eng.debug_steps(64)
    finally:
        eng.stop()
    steps = [r for r in snap["steps"] if "wall_s" in r]
    modes = {r["batch"]["mode"] for r in steps}
    assert "spec_verify" in modes
    for r in steps:
        assert sum(r["phases"].values()) == pytest.approx(r["wall_s"],
                                                          rel=1e-9)
        assert r["arena"]["pages_total"] == eng._kv_store.pool.n_pages
    roll = snap["rollup"]
    assert roll["steps"] >= len(steps) and roll["spec_steps"] >= 1
    assert roll["bytes"] <= roll["max_bytes"]
    assert snap["recompiles"]["paged_verify"]["recompiles"] == 0
    events = [r for r in eng.recorder.records() if r.get("event")]
    assert eng.counters["chunk_interleaved_steps"] == sum(
        e["steps"] for e in events)
