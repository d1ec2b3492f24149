"""The engine's step graphs and their capture watchdog, on the CPU.

- ``StepGraph.run`` stages the host's values through its one buffer into
  the static slot tensors and, on the CPU, runs the eager step on them: its
  logits and arena equal a direct ``paged_decode_step`` (width 1) or
  ``paged_verify_step`` (width 4) call over two steps whose tokens,
  lengths and one table page change between them (a stale static buffer
  would show), for the plain, int8-KV, MLA and int8-latent layouts of the
  f32 tiny models;
- inactive slots and rows past ``n_tokens`` write only the sink page;
- the recapture trigger: the baked-tensor key moves with a reassigned
  arena section or params leaf, not with new values;
- the engine on the staged path gives the JAX engine's greedy tokens, with
  and without speculation, and every decode step went through its graphs;
- ``_recover`` keeps every arena section in place, zeroed, and the engine
  then serves the same greedy tokens;
- the port's ``CompileWatchdog`` (captures for compiles): the first
  capture is the contract, recaptures are counted and logged with the
  moved tensor named, the warning past budget comes once, a stable graph
  counts once, and its snapshot equals the JAX ``CompileWatchdog``'s for
  the same sequence of events through a real ``jax.jit``.
"""

import logging
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from k8s_runpod_kubelet_tpu.models import init_params as jax_init_params
from k8s_runpod_kubelet_tpu.models import llama as jllama
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingConfig as JaxServingConfig
from k8s_runpod_kubelet_tpu.workloads.serving import \
    ServingEngine as JaxServingEngine
from k8s_runpod_kubelet_tpu.workloads.serving.recorder import \
    CompileWatchdog as JaxCompileWatchdog
from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
from k8s_runpod_kubelet_tpu_torch.models.from_jax import (config_from_jax,
                                                          params_from_jax)
from k8s_runpod_kubelet_tpu_torch.workloads.serving import (ServingConfig,
                                                            ServingEngine)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.recorder import (
    CompileWatchdog, _fingerprint)
from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import \
    StepGraph

TIMEOUT = 120
DENSE = jllama.tiny_llama(vocab_size=128, embed_dim=64, n_layers=2,
                          n_heads=4, n_kv_heads=2, mlp_dim=128,
                          max_seq_len=512, dtype=jnp.float32,
                          param_dtype=jnp.float32)
MLA = jllama.tiny_mla(vocab_size=128, embed_dim=64, n_layers=2, mlp_dim=128,
                      max_seq_len=512, dtype=jnp.float32,
                      param_dtype=jnp.float32)
LAYOUTS = {"plain": (DENSE, False), "kv_int8": (DENSE, True),
           "mla": (MLA, False), "mla_int8": (MLA, True)}
SLOTS, T, COLS = 4, 8, 16
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], [3, 1, 4, 1, 5, 9, 2, 6],
           [((i * 37) % 120) + 1 for i in range(30)]]
RECORDER_LOGGER = "k8s_runpod_kubelet_tpu_torch.workloads.serving.recorder"


@pytest.fixture(scope="module")
def trees():
    return {name: jax_init_params(jcfg, jax.random.PRNGKey(0))
            for name, jcfg in (("dense", DENSE), ("mla", MLA))}


def _port(jcfg, jtree):
    cfg = config_from_jax(jcfg, torch.float32)
    return cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                                cfg, device="cpu")


def _layout(trees, layout):
    jcfg, kv_int8 = LAYOUTS[layout]
    cfg, params = _port(jcfg, trees["mla" if jcfg is MLA else "dense"])
    model = LlamaModel(cfg, "cpu")
    arena = model.init_paged_arena(SLOTS * COLS + 4, T, quantize=kv_int8)
    gen = torch.Generator().manual_seed(11)
    for name, a in sorted(arena.items()):
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 128, a.shape, generator=gen,
                                  dtype=torch.int8))
        elif name.endswith("scale"):
            a.copy_(torch.rand(a.shape, generator=gen) * 0.02 + 0.005)
        else:
            a.copy_(torch.randn(a.shape, generator=gen))
    return cfg, params, model, arena


def _steps(width: int, rng: np.random.Generator, vocab: int):
    """Two steps' host values: slot 1 crosses into a page that only the
    second step's table names; slot 2 is inactive in both."""
    lengths = np.array([3, 2 * T - width, 40, 21], np.int32)
    active = np.array([True, True, False, True])
    n_tokens = np.array([width, width, 0, 1], np.int32)
    perm = rng.permutation(SLOTS * COLS).astype(np.int32).reshape(SLOTS,
                                                                  COLS)
    out = []
    for _ in range(2):
        live = -(-(lengths + n_tokens) // T)
        tables = np.where(np.arange(COLS)[None] < live[:, None], perm, 0)
        tokens = rng.integers(0, vocab, (SLOTS, width)).astype(np.int32)
        out.append((tokens, lengths.copy(), tables.astype(np.int32),
                    active, n_tokens))
        lengths = lengths + n_tokens
    assert (-(-(out[1][1] + n_tokens) // T))[1] == \
        (-(-(out[0][1] + n_tokens) // T))[1] + 1
    return out


def _direct(model, params, arena, width, tokens, lengths, tables, active,
            n_tokens):
    t = (torch.from_numpy(tokens), torch.from_numpy(lengths),
         torch.from_numpy(tables), torch.from_numpy(active),
         torch.from_numpy(n_tokens))
    if width == 1:
        logits, _, _ = model.paged_decode_step(params, t[0][:, 0], arena,
                                               t[2], t[1], t[3])
        return logits
    logits, _ = model.paged_verify_step(params, t[0], arena, t[2], t[1],
                                        t[3], t[4])
    return logits


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step_graph_run_matches_the_direct_step(trees, layout, width):
    cfg, params, model, arena = _layout(trees, layout)
    ref_arena = {k: v.clone() for k, v in arena.items()}
    graph = StepGraph(model, width, SLOTS, COLS)
    rng = np.random.default_rng(5)
    for step in _steps(width, rng, cfg.vocab_size):
        got = graph.run(params, arena, *step)
        ref = _direct(model, params, ref_arena, width, *step)
        assert torch.equal(got, ref), (layout, width)
        for name in arena:
            assert torch.equal(arena[name], ref_arena[name]), name
        # the staged values are what the step read
        assert torch.equal(graph.static["tables"],
                           torch.from_numpy(step[2]))
    assert graph.captures == 0 and graph.replays == 0   # the CPU steps


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_inactive_slots_write_only_the_sink_page(trees, layout):
    cfg, params, model, arena = _layout(trees, layout)
    width = 3
    before = {k: v.clone() for k, v in arena.items()}
    graph = StepGraph(model, width, SLOTS, COLS)
    rng = np.random.default_rng(9)
    tokens, lengths, tables, active, n_tokens = _steps(
        width, rng, cfg.vocab_size)[0]
    # inactive slot 2's stale row aliases slot 0's live tail page
    tables[2, :3] = tables[0, 0]
    graph.run(params, arena, tokens, lengths, tables, active, n_tokens)
    sink = SLOTS * COLS + 4
    written = {(int(tables[b, (int(lengths[b]) + j) // T]),
                (int(lengths[b]) + j) % T)
               for b in range(SLOTS) for j in range(int(n_tokens[b]))}
    changed = set()
    for name, a in arena.items():
        diff = (a != before[name]).reshape(a.shape[0], a.shape[1], T, -1)
        pages, offs = diff.any(dim=(0, 3)).nonzero(as_tuple=True)
        changed |= {(int(p), int(o)) for p, o in zip(pages, offs)}
    assert {(p, o) for p, o in changed if p != sink} == written
    assert any(p == sink for p, _ in changed)


def test_baked_key_moves_with_tensors_not_values(trees):
    _, params, model, arena = _layout(trees, "kv_int8")
    key = StepGraph._key_of(params, arena)
    arena["k"].add_(1)
    params["final_norm"].mul_(2)
    assert StepGraph._key_of(params, arena) == key
    moved = dict(arena, k=arena["k"].clone())
    assert StepGraph._key_of(params, moved) != key
    lp = dict(params["layers"], wq=params["layers"]["wq"].clone())
    assert StepGraph._key_of(dict(params, layers=lp), arena) != key
    lines = _fingerprint({"arena": moved})
    assert any(line.startswith("arena.k:torch.int8(") and "#0x" in line
               for line in lines)


def _leak_free(engine) -> bool:
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    return (store.pool.free_count + len(nodes) == store.pool.n_pages
            and all(store.pool.refcount(n.page) == 1 for n in nodes))


def _drain(engine):
    engine.drain()
    wait = threading.Event()
    for _ in range(TIMEOUT * 20):
        if engine.drained:
            return
        wait.wait(0.05)
    raise AssertionError("engine did not drain")


def _one_by_one(engine, prompts, **kw):
    return [engine.submit(p, **kw).result(timeout=TIMEOUT)["tokens"]
            for p in prompts]


@pytest.mark.parametrize("speculate_k", [0, 3])
def test_staged_engine_matches_the_jax_engine(trees, speculate_k):
    sc = dict(slots=2, max_prefill_len=16, cache_len=128, max_new_tokens=20,
              kv_page_tokens=8, speculate_k=speculate_k)
    jeng = JaxServingEngine(DENSE, trees["dense"],
                            JaxServingConfig(**sc)).start()
    try:
        ref = _one_by_one(jeng, PROMPTS)
    finally:
        jeng.stop()
    cfg, params = _port(DENSE, trees["dense"])
    eng = ServingEngine(cfg, params, ServingConfig(**sc), device="cpu")
    steps = {}
    for tracked in eng._graphs():
        graph, inner = tracked.fn, tracked.fn._step

        def counted(*a, _inner=inner, _name=tracked.name):
            steps[_name] = steps.get(_name, 0) + 1
            return _inner(*a)

        graph._step = counted
    eng.start()
    try:
        got = _one_by_one(eng, PROMPTS)
        # a sampled request alone: with speculation, a step with no greedy
        # slot is the width-1 step
        eng.submit(PROMPTS[0], temperature=0.8, seed=3).result(
            timeout=TIMEOUT)
        _drain(eng)
        assert _leak_free(eng)
        decode_steps = eng.counters["decode_steps"]
        graphs = eng.debug_snapshot()["graphs"]
    finally:
        eng.stop()
    assert got == ref
    # every decode and verify step ran through a step graph's buffers
    assert sum(steps.values()) == decode_steps > 0
    assert set(steps) == ({"paged_step", "paged_verify"} if speculate_k
                          else {"paged_step"})
    assert set(graphs) == set(steps)
    for name, g in graphs.items():
        assert g["compiles"] == 0 and g["replays"] == 0   # no capture here
        assert g["width"] == (1 if name == "paged_step" else speculate_k + 1)


@pytest.mark.parametrize("layout", ["plain", "mla_int8"])
def test_recover_keeps_the_arena_in_place(trees, layout):
    jcfg, kv_int8 = LAYOUTS[layout]
    cfg, params = _port(jcfg, trees["mla" if jcfg is MLA else "dense"])
    eng = ServingEngine(cfg, params, ServingConfig(
        slots=2, max_prefill_len=16, cache_len=128, max_new_tokens=12,
        kv_page_tokens=8, quantize_kv_int8=kv_int8), device="cpu").start()
    try:
        ref = _one_by_one(eng, PROMPTS[:2])
        arena = eng._kv_store.arena
        ptrs = {k: v.data_ptr() for k, v in arena.items()}
        old_store = eng._kv_store
        commit = eng._commit_decode

        def boom(logits):
            eng._commit_decode = commit
            raise RuntimeError("injected step failure")

        eng._commit_decode = boom
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit(PROMPTS[2]).result(timeout=TIMEOUT)
        wait = threading.Event()
        for _ in range(TIMEOUT * 20):
            if eng._kv_store is not old_store:
                break
            wait.wait(0.05)
        store = eng._kv_store
        assert store is not old_store and eng.counters["engine_errors"] == 1
        assert store.pool.free_count == store.pool.n_pages
        assert {k: v.data_ptr() for k, v in store.arena.items()} == ptrs
        assert all(not v.any() for v in store.arena.values())
        assert _one_by_one(eng, PROMPTS[:2]) == ref
        snap = eng.debug_snapshot()
        assert snap["last_error"].startswith("RuntimeError")
        assert eng.watchdog.total_recompiles() == 0
    finally:
        eng.stop()


# -- the watchdog ---------------------------------------------------------------

class _FakeGraph:
    """A capture seam for the watchdog: each call whose ``moved`` is set
    'captures' again, over an arena section reallocated like a rebuilt
    arena's."""

    def __init__(self):
        self.captures = 0
        self.calls = 0
        self.arena = {"k": torch.zeros((2, 4)), "v": torch.zeros((2, 4))}

    def __call__(self, moved: bool):
        self.calls += 1
        if moved:
            if self.captures:
                self.arena = dict(self.arena, k=torch.zeros((2, 4)))
            self.captures += 1

    def baked(self):
        return {"arena": self.arena}


def test_first_capture_is_the_contract_not_a_finding(caplog):
    wd = CompileWatchdog()
    g = wd.wrap("paged_step", _FakeGraph(), budget=2)
    with caplog.at_level(logging.INFO, logger=RECORDER_LOGGER):
        g(True)
    assert not caplog.records
    assert wd.snapshot()["paged_step"] == {"compiles": 1, "recompiles": 0,
                                           "budget": 2, "warned": False}


def test_recaptures_counted_and_warned_once_naming_the_moved_tensor(caplog):
    wd = CompileWatchdog()
    fake = _FakeGraph()
    g = wd.wrap("paged_step", fake, budget=2)
    with caplog.at_level(logging.INFO, logger=RECORDER_LOGGER):
        g(True)     # capture 1: free
        g(True)     # capture 2: a recapture, within budget
        g(True)     # capture 3: past budget -> warn
        g(True)     # capture 4: the warning NOT repeated
        g(False)    # a replay: nothing
    assert fake.calls == 5
    infos = [r for r in caplog.records if r.levelno == logging.INFO]
    warns = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(infos) == 3 and len(warns) == 1
    assert "budget 2" in warns[0].getMessage()
    # the diff names the arena section that moved, and only it
    diff = g.last_diff
    assert diff and all(line[1:].startswith("arena.k:") for line in diff)
    assert "arena.k:" in warns[0].getMessage()
    assert wd.snapshot()["paged_step"]["warned"] is True
    assert wd.total_recompiles() == 3


def test_stable_capture_counts_exactly_once():
    wd = CompileWatchdog()
    g = wd.wrap("paged_verify", _FakeGraph(), budget=2)
    g(True)
    for _ in range(20):
        g(False)
    assert wd.snapshot()["paged_verify"]["compiles"] == 1
    assert wd.total_recompiles() == 0


def test_budget_none_tracks_without_alarm(caplog):
    wd = CompileWatchdog()
    g = wd.wrap("bucketed", _FakeGraph(), budget=None)
    with caplog.at_level(logging.WARNING, logger=RECORDER_LOGGER):
        for _ in range(6):
            g(True)
    assert wd.snapshot()["bucketed"]["compiles"] == 6
    assert not caplog.records


def test_wrap_none_passes_through_and_no_seam_detects_nothing():
    wd = CompileWatchdog()
    assert wd.wrap("missing", None) is None
    calls = []
    f = wd.wrap("plain", lambda x: calls.append(x), budget=2)
    f(1)
    f(2)
    assert calls == [1, 2]
    assert wd.snapshot()["plain"]["compiles"] == 0


@pytest.mark.parametrize("shapes", [(4, 4, 4, 4), (1, 2, 3, 4),
                                    (2, 2, 3, 3, 5, 5, 7),
                                    (3, 3, 3, 6, 6)],
                         ids=["stable", "every_call", "pairs", "once_moved"])
def test_snapshot_matches_the_jax_watchdog(shapes):
    """The same events through both watchdogs: a real jax.jit whose input
    shape changes at the calls where the fake graph's arena moves."""
    jwd = JaxCompileWatchdog()
    jf = jwd.wrap("paged_step", jax.jit(lambda x: x * 2), budget=2)
    pwd = CompileWatchdog()
    pf = pwd.wrap("paged_step", _FakeGraph(), budget=2)
    last = None
    for n in shapes:
        jf(jnp.zeros((n,), jnp.float32))
        pf(n != last)
        last = n
    assert pwd.snapshot() == jwd.snapshot()
    assert pwd.total_recompiles() == jwd.total_recompiles()
