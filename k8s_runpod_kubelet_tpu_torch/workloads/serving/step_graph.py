"""One paged model step at a fixed width as one CUDA graph: the port's
counterpart of the JAX engine's jitted ``paged_decode_step`` and
``paged_verify_step`` (``workloads/serving/engine.py`` of the JAX package
wraps each in ``jax.jit`` with the arena donated).

A decode step eagerly is 32 layers of ~15 ops, each paged-attention and
int4 call with its Python shape checks and ctypes launch: the card idles
for most of the step's wall. A ``StepGraph`` captures the whole step once
and replays it, fed by static device buffers that live as long as it:

- tokens (B, K), lengths (B,), active (B,), n_tokens (B,), the page
  tables (B, cols) and the slots' multi-LoRA adapter ids (B,), all int32
  slices of ONE device buffer. ``run`` packs the host's values into a host
  staging buffer of the same layout (pinned on a card) and makes one
  host-to-card copy a step;
- the logits, written by the replay into the graph's pool: (B, V) f32 at
  K = 1 (``paged_decode_step``), (B, K, V) at K > 1
  (``paged_verify_step``). They hold until the next replay of a graph of
  the same pool.

A graph bakes in the pointers of the params, the arena sections, the
adapter stacks (when the engine serves adapters), the rope tables and the
static buffers. ``run`` takes the params, the arena and the adapter stacks
as jit takes its arguments: if any of their tensors moved, it captures again
(the engine's ``CompileWatchdog`` counts and logs every capture after the
first, ``recorder.py``). Split-KV plans and int4 split counts depend on
shapes only, which is what lets one graph serve every length. An adapter
registered by writing into the stacks in place, like a new slot's adapter
id, is data the next replay reads: no capture.

A replay launches the paged kernel once a layer and ``rms_norm`` 2L + 1
times (each layer's two norms and the final one), and 4L + 1 with a q/k
norm: 32 and 65 at llama3-8b and mistral-7b, 28 and 57 at gemma-7b and
qwen2-7b, 36 and 145 at qwen3-8b. A zero-centered norm's (1 + w), a
bias's add and a windowed model's band are plain ops or kernel arguments
inside the same capture.

``DecodeGraph`` is the contiguous loop's step (the JAX engine's jitted
``decode_step``, and at width K + 1 its jitted speculative ``verify_step``):
the step over the engine's batch cache, fed by a staged (tokens, active,
adapter ids) buffer, with no host sync inside (the step's ``check``
off). Its graph bakes in the cache's sections, both RoPE tables and the
adapter stacks; each slot's adapter id is data, as on the paged steps, so
mixed ids share one replay and an adapter written into the stacks in
place needs no capture. A replay launches ``rms_norm`` 2L +
1 times, 4L + 1 with sandwich norms or the q/k norm and 6L + 1 with both
(gemma2-9b 169, gemma3-12b 289, llama3-8b 65), at any width; its
attention is the plain f32 einsum, no kernel (over a head-sharded cache
each shard's q heads attend its own kv heads).

On the CPU the same staged buffers feed the eager step: the dispatch is on
the model's device, as in the kernel wrappers, and not a fallback. On a
card nothing falls back: a failed capture or replay raises.
"""

from __future__ import annotations

import os
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch

from ...ops import (int4_expert_matmul, int4_matmul, int4_matmul_sharded,
                    paged_attention,
                    paged_attention_mla, paged_attention_mla_quant,
                    paged_attention_multi, paged_attention_multi_mla,
                    paged_attention_multi_mla_quant,
                    paged_attention_multi_quant, paged_attention_quant,
                    rms_norm)

# every kernel wrapper a paged step can reach: a capture records how many
# times each launched into the graph, and each replay adds that to its count
COUNTED = (paged_attention_multi, paged_attention_multi_quant,
           paged_attention_multi_mla, paged_attention_multi_mla_quant,
           paged_attention, paged_attention_quant, paged_attention_mla,
           paged_attention_mla_quant, rms_norm, int4_matmul,
           int4_expert_matmul, int4_matmul_sharded)

# the kernel each multi-token wrapper launches once a call, by the name a
# profiler or a graph's description reads (split-KV merges and int4 split
# reductions are other kernels; the single-token forms launch the same
# kernels at K = 1)
KERNEL_NAMES = {
    "paged_attention_multi": "paged_attention_multi_kernel",
    "paged_attention_multi_quant": "paged_attention_multi_quant_kernel",
    "paged_attention_multi_mla": "paged_attention_multi_mla_kernel",
    "paged_attention_multi_mla_quant":
        "paged_attention_multi_mla_quant_kernel",
    "rms_norm": "_rms_kernel",
    "int4_matmul": "int4_matmul_kernel",
    "int4_expert_matmul": "int4_expert_matmul_kernel",
    "int4_matmul_sharded": "int4_matmul_sharded_kernel",
}

# eager steps before a capture: the first builds the nvcc libraries and
# compiles the Triton kernel, the second runs warm
WARMUP_STEPS = 2

_SECTIONS = ("tokens", "lengths", "active", "n_tokens", "tables",
             "adapter_ids")


def graph_kernels(graph: torch.cuda.CUDAGraph) -> dict:
    """The kernel nodes of a captured graph, kept with ``keep_graph=True``,
    counted by wrapper name (KERNEL_NAMES): what each replay launches,
    read from the graph's own description (``cudaGraphDebugDotPrint``,
    where a node's ``| {ID | n | name<<<grid>>>}`` line names its
    kernel), not from a profiler trace (late in a long process on an
    H100, every trace of a replay lost the same few records)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():     # the dump's own debug notes
            warnings.simplefilter("ignore")
            graph.debug_dump(path)
        with open(path) as f:
            nodes = [line for line in f if line.startswith("| {ID |")]
    return {w: sum(k in line for line in nodes)
            for w, k in KERNEL_NAMES.items()}


def _leaves(tree, out: list) -> list:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


class StepGraph:
    """``paged_decode_step`` (``width`` 1) or ``paged_verify_step``
    (``width`` K) of ``model`` over ``slots`` slots and page tables of
    ``table_cols`` columns, captured once and replayed."""

    def __init__(self, model, width: int, slots: int, table_cols: int):
        if width < 1 or slots < 1 or table_cols < 1:
            raise ValueError("width, slots and table_cols must be >= 1")
        self.model = model
        self.width = width
        self.slots = slots
        self.table_cols = table_cols
        dev = model.device
        self._cuda = dev.type == "cuda"
        shapes = {"tokens": (slots, width), "lengths": (slots,),
                  "active": (slots,), "n_tokens": (slots,),
                  "tables": (slots, table_cols), "adapter_ids": (slots,)}
        spans, n = {}, 0
        for name in _SECTIONS:
            size = int(np.prod(shapes[name]))
            spans[name] = (n, size)
            # each section starts on 16 bytes: the MLA kernels take
            # 16-byte aligned tables
            n += -(-size // 4) * 4
        self._host = torch.zeros(n, dtype=torch.int32, pin_memory=self._cuda)
        self._dev = torch.zeros(n, dtype=torch.int32, device=dev)
        host = self._host.numpy()
        self._staged = {k: host[o:o + s].reshape(shapes[k])
                        for k, (o, s) in spans.items()}
        self.static = {k: self._dev[o:o + s].view(shapes[k])
                       for k, (o, s) in spans.items()}
        self._copied = torch.cuda.Event() if self._cuda else None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._pool = None
        self._key = None
        self._params = self._arena = self._adapters = None
        self.logits: Optional[torch.Tensor] = None
        self.captures = 0
        self.replays = 0
        self.launches_per_replay: dict[str, int] = {}
        self.capture_memory: dict[str, int] = {}

    # -- what the watchdog reads ----------------------------------------------

    def baked(self) -> dict:
        """Every tensor the captured graph holds a pointer to."""
        m = self.model
        return {"params": self._params, "arena": self._arena,
                "adapters": self._adapters,
                "rope": {"cos": m.cos, "sin": m.sin,
                         "cos_local": m.cos_local, "sin_local": m.sin_local},
                "static": self.static}

    @staticmethod
    def _key_of(params, arena, adapters=None) -> tuple:
        return tuple((t.data_ptr(), t.dtype, t.shape)
                     for t in _leaves((params, arena, adapters), []))

    # -- the step -------------------------------------------------------------

    def _step(self, params, arena, adapters) -> torch.Tensor:
        s = self.static
        active = s["active"] != 0
        ids = s["adapter_ids"] if adapters else None
        if self.width == 1:
            logits, _, _ = self.model.paged_decode_step(
                params, s["tokens"][:, 0], arena, s["tables"], s["lengths"],
                active, adapters=adapters, adapter_ids=ids)
            return logits
        logits, _ = self.model.paged_verify_step(
            params, s["tokens"], arena, s["tables"], s["lengths"], active,
            s["n_tokens"], adapters=adapters, adapter_ids=ids)
        return logits

    def capture(self, params, arena, pool=None, adapters=None) -> None:
        """Warm up on a side stream, then capture the step (into ``pool``,
        a ``torch.cuda.graph_pool_handle()`` graphs may share), with the
        multi-LoRA ``adapters`` stacks when given. Every slot
        is inactive meanwhile (n_tokens 0), so each K/V row the warm-up
        writes lands on the sink page and no live page is touched. The
        engine's threads must not be running: a capture is not safe
        against another thread's CUDA calls."""
        if not self._cuda:
            raise ValueError("a CUDA graph is captured on a card; on the "
                             "CPU run() steps eagerly")
        dev = self.model.device
        self._copied.synchronize()
        self._host.zero_()
        self._dev.copy_(self._host)
        torch.cuda.synchronize(dev)
        mem = {"allocated_before": torch.cuda.memory_allocated(dev),
               "peak_before": torch.cuda.max_memory_allocated(dev),
               "reserved_before": torch.cuda.memory_reserved(dev)}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step(params, arena, adapters)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [k.launches for k in COUNTED]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=pool):
            logits = self._step(params, arena, adapters)
        graph.instantiate()
        # the capture ran nothing: its launches count at each replay
        self.launches_per_replay = {k.__name__: k.launches - n
                                    for k, n in zip(COUNTED, before)}
        for k, n in zip(COUNTED, before):
            k.launches = n
        torch.cuda.synchronize(dev)
        mem.update(allocated_after=torch.cuda.memory_allocated(dev),
                   peak_after=torch.cuda.max_memory_allocated(dev),
                   reserved_after=torch.cuda.memory_reserved(dev))
        self.capture_memory = mem
        self._graph, self._pool, self.logits = graph, pool, logits
        self._params, self._arena, self._adapters = params, arena, adapters
        self._key = self._key_of(params, arena, adapters)
        self.captures += 1

    def kernels_in_graph(self) -> dict:
        """The counted kernels each replay launches, from the captured
        graph's nodes (``graph_kernels``)."""
        return graph_kernels(self._graph)

    def run(self, params, arena, tokens, lengths, tables, active,
            n_tokens=None, adapters=None, adapter_ids=None) -> torch.Tensor:
        """One step over the host's values: tokens (B, K) (or (B,) at
        K = 1), lengths (B,), tables (B, cols), active (B,), n_tokens (B,)
        (default K for an active slot, 0 otherwise), and with the
        ``adapters`` stacks each slot's ``adapter_ids`` (B,) (default 0,
        the base). Returns the logits: on a card the graph's static
        output, after a replay (and a capture first if params, the arena
        or the adapter stacks moved); on the CPU the eager step's."""
        st = self._stage(params, arena, adapters)
        active = np.asarray(active)
        st["tokens"][:] = np.asarray(tokens).reshape(self.slots, self.width)
        st["lengths"][:] = lengths
        st["tables"][:] = tables
        st["active"][:] = active
        st["n_tokens"][:] = (active * self.width if n_tokens is None
                             else n_tokens)
        st["adapter_ids"][:] = 0 if adapter_ids is None else adapter_ids
        return self._launch(params, arena, adapters)

    __call__ = run

    def _stage(self, params, arena, adapters) -> dict:
        """Capture again if a baked tensor moved, wait until the last
        host-to-card copy has read the staging buffer, and return it."""
        if self._cuda and self._key_of(params, arena, adapters) != self._key:
            self.capture(params, arena, self._pool, adapters)
        if self._cuda:
            self._copied.synchronize()   # the last copy read the buffer
        return self._staged

    def _launch(self, params, arena, adapters) -> torch.Tensor:
        """One host-to-card copy of the staged values, then the replay (or
        on the CPU the eager step)."""
        self._dev.copy_(self._host, non_blocking=True)
        if not self._cuda:
            return self._step(params, arena, adapters)
        self._copied.record()
        self._graph.replay()
        for k in COUNTED:
            k.launches += self.launches_per_replay[k.__name__]
        self.replays += 1
        return self.logits


class DecodeGraph(StepGraph):
    """``decode_step`` (``width`` 1) or ``verify_step`` (``width`` K + 1,
    the speculative verify) of ``model`` over a contiguous batch cache of
    ``slots`` rows, captured once and replayed (the module docstring). The
    verify step writes every active row's K + 1 positions and advances no
    index: the engine moves each row's index by what it committed. The
    capture's warm-up steps run with every row inactive, which writes
    nothing and advances no index."""

    def __init__(self, model, slots: int, width: int = 1):
        super().__init__(model, width, slots, 1)

    def _step(self, params, cache, adapters=None) -> torch.Tensor:
        s = self.static
        ids = s["adapter_ids"] if adapters else None
        active = s["active"] != 0
        if self.width == 1:
            logits, _ = self.model.decode_step(
                params, s["tokens"][:, 0], cache, active, adapters=adapters,
                adapter_ids=ids, check=False)
            return logits
        logits, _ = self.model.verify_step(params, s["tokens"], cache, active,
                                           adapters=adapters,
                                           adapter_ids=ids, check=False)
        return logits

    def run(self, params, cache, tokens, active, adapters=None,
            adapter_ids=None) -> torch.Tensor:
        """One step over the host's values, tokens (B,) or (B, K + 1) and
        active (B,), and with the multi-LoRA ``adapters`` stacks each
        slot's ``adapter_ids`` (B,) (default 0, the base): the cache's
        active rows take their tokens' K/V (and at width 1 advance their
        index). Returns the logits, (B, V) or (B, K + 1, V) f32 (on a card
        the graph's static output)."""
        st = self._stage(params, cache, adapters)
        st["tokens"][:] = np.asarray(tokens).reshape(self.slots, self.width)
        st["active"][:] = np.asarray(active)
        st["adapter_ids"][:] = 0 if adapter_ids is None else adapter_ids
        return self._launch(params, cache, adapters)

    __call__ = run
