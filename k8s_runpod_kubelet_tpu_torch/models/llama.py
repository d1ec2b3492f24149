"""Llama-3-family decoder (port of the JAX package's ``models/llama.py``):
the contiguous ``forward`` that training and embeddings run, the
contiguous serving steps over a linear, ring or mixed cache (``prefill``,
``prefill_chunk_step``, ``verify_step``, ``decode_step``; Gemma 2 and 3's
local/global window interleave keeps rings for its local layers), and
the paged serving steps
over a KV arena, for dense attention and for Multi-head Latent Attention
(MLA, DeepSeek-V2). MLA's contiguous forward and prefill run its direct
form (per-head K and V from the latent, the flash kernels at head_dim +
rope_dim); its cache, contiguous or paged, holds the latent, and its
serving steps read it in the absorbed form.

Parameters are a plain dict in the JAX package's tree layout, stacked over
layers: ``tok_embed`` (V, E), ``final_norm`` (E,), ``lm_head`` (E, V) and
``layers/*`` with a leading (L, ...) axis. Serving stores matmul weights,
the embedding and the LM head in the compute dtype (the JAX model keeps
f32 params and casts them to ``cfg.dtype`` at every use, which gives the
same values); training keeps f32 master weights (``cfg.param_dtype``) and
casts them at every use, as the JAX model does. Norm weights stay f32,
because RMSNorm applies them in f32.

Serving may also hold quantized matmul weights (``models/quant.py``):
``{"q8", "scale"}`` and ``{"q4", "scale"}`` dict leaves, which ``_mm``
multiplies by (int4 through the ``int4_matmul`` kernel).

Under a mesh with ``tensor`` = N > 1 (``parallel.Mesh``) the model serves
tensor-parallel, as the JAX model does under a mesh with a ``tensor`` axis:
its tree is laid out by ``parallel.shard_params`` (in one process each
split leaf stacks the N shards' slices, over a process group it is the
rank's slice). Activations stay whole between the ops: a column-split
product (wq, wk, wv, w_gate, w_up, the LM head; every int4 leaf, through
``int4_matmul_sharded``) gathers its shards' outputs, a row-split one (wo
and w_down in bf16 and int8) adds its shards' partial sums, the psum; the
embedding adds each shard's gather from its own vocab rows, other rows
zero, which equals the JAX model's one-hot contraction. The paged arena
shards its kv-head axis when ``paged_head_shards`` says so (each shard's
kernels then launch on its own contiguous arena), else it replicates.

A sparse-MoE config (``n_experts`` > 0, Mixtral) holds ``router`` (L, E, X)
in f32, as the JAX model routes in f32, and ``we_gate``/``we_up`` (L, X, E,
M) and ``we_down`` (L, X, M, E) in place of the dense MLP's three leaves;
the MLP of every layer is then ``models/moe.py``'s ``moe_mlp`` (int4
experts through the ``int4_expert_matmul`` kernel). DeepSeek-MoE adds
``ws_gate``/``ws_up`` (L, E, S·M) and ``ws_down`` (L, S·M, E), its S
shared experts as one dense SwiGLU, and V3's ``router_bias`` (L, X) f32;
its first ``n_dense_prefix`` layers are a stack of their own,
``prefix_layers``, with a dense MLP at ``dense_prefix_mlp_dim``, which run
before ``layers`` and cache into their own sections (``c_pre``/``kr_pre``,
the JAX layout). Training routes at ``capacity_factor`` and adds the
router's scaled losses, ``forward(with_aux=True)``'s second output, to
its objective.

Multi-LoRA serving (the JAX model's ``adapters``/``adapter_ids``): every
serving step takes per-request adapters, ``{target: {"a": (L, N, in, r),
"b": (L, N, r, out), "scale": (L, N)}}`` stacks over N adapter slots, and
``adapter_ids`` (B,) choosing one slot a row; slot 0 is all zeros, the base
model. Each target's delta (``_ml_delta``) is added after its product, on
the whole input and output even under a tensor mesh (adapters stay whole,
as in the JAX package). MLA refuses adapters, and an MoE model adapts its
attention projections only. A training tree may instead hold LoRA-wrapped
leaves ``{"w", "lora_a", "lora_b", "scale"}`` (``models/lora.py``), which
``_mm`` multiplies by with the base weight detached.

The arena is ``{"k", "v"}`` of shape (L, P + 1, T, Hkv, D) and is updated
IN PLACE (the JAX model donated it instead); an int8 arena adds
``k_scale``/``v_scale`` (L, P + 1, T, Hkv) f32. A head-sharded arena holds
Hkv/N heads: in one process its sections are (N·L, P + 1, T, Hkv/N, ...),
the (N, L, ...) stack of the shards' arenas with its two leading axes
merged, so that every (shard, layer) slice is one contiguous arena and the
page axis stays axis 1 for the pool's copies; over a process group they
are the rank's (L, P + 1, T, Hkv/N, ...). An MLA model's arena is
headless: ``{"c", "kr"}`` of shape (L, P + 1, T, r) and (L, P + 1, T, dr),
the normed latent and the shared rotated rope key of each position, plus
``c_scale``/``kr_scale`` (L, P + 1, T) f32 when int8. Page P is a sink no
page table names: rows that must not be written (past ``n_tokens``,
inactive slots, whose stale table rows may alias another slot's live tail
page) scatter there, in every section, where the JAX model used page id P
with ``mode="drop"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..device import resolve_device
from ..ops import (apply_rope, flash_attention, int4_matmul,
                   int4_matmul_sharded, paged_attention_multi,
                   paged_attention_multi_mla, paged_attention_multi_mla_quant,
                   paged_attention_multi_quant, rms_norm, rope_frequencies)
from ..ops.attention import paged_head_shards
from ..ops.ring_attention import ring_attention
from ..parallel.sharding import (all_gather, all_reduce,
                                 check_expert_parallel,
                                 check_tensor_parallel, param_logical_axes,
                                 tensor_axis)
from .moe import moe_mlp

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The fields of the JAX ``LlamaConfig`` this port runs, with the same
    defaults (weight and KV quantization and LoRA adapters are serving
    options, ``ServingConfig``): the Llama body and its Gemma, Mistral-7B,
    Qwen2 and Qwen3 branches (a sliding window, uniform or in a
    local/global pattern, GeGLU, the embedding scale, zero-centered norms,
    sandwich norms, soft caps on scores and logits, the query
    pre-attention scalar, a local RoPE base, q/k/v biases and the q/k
    norm), and DeepSeek-MoE's (shared experts, V3's sigmoid routing and
    the dense-prefix layers)."""
    name: str = "tiny"
    vocab_size: int = 32000
    embed_dim: int = 256
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: Optional[int] = None      # default embed_dim // n_heads
    mlp_dim: int = 688
    max_seq_len: int = 2048
    rope_theta: float = 500_000.0
    rope_scaling: Optional[dict] = None
    norm_eps: float = 1e-5
    # Mistral's sliding window: each position attends the last W positions
    # (None: full causal), in every layer at pattern 1
    sliding_window: Optional[int] = None
    # Gemma 2 and 3's local/global interleave: layers repeat in groups of
    # this many, the last of a group global (full causal) and the rest
    # under ``sliding_window`` (``layer_windows``)
    sliding_window_pattern: int = 1
    # Gemma 2: attention scores pass cap * tanh(s / cap) before the mask
    attn_logit_softcap: Optional[float] = None
    # Gemma 2 and 3: q scales by this ** -0.5 instead of head_dim ** -0.5
    query_pre_attn_scalar: Optional[float] = None
    # Gemma 2 and 3's sandwich norms: an RMSNorm on each sublayer's output
    # (attn_post_norm, mlp_post_norm) before the residual add
    post_norms: bool = False
    # Gemma 3: windowed layers rotate with this base and no scaling, global
    # ones with rope_theta and rope_scaling (None: one table)
    rope_local_theta: Optional[float] = None
    # Gemma 2: the LM head's logits pass cap * tanh(l / cap)
    logit_softcap: Optional[float] = None
    # Qwen3's (and Gemma 3's) RMSNorm over head_dim on q and k, one weight
    # a layer shared by the heads, before RoPE
    qk_norm: bool = False
    tie_embeddings: bool = False
    mlp_activation: str = "silu"        # "silu" (SwiGLU) | "gelu_tanh" (GeGLU)
    embed_scale: bool = False           # embeddings times sqrt(embed_dim)
    # RMSNorm weights stored as w and applied as (1 + w) (Gemma)
    norm_zero_centered: bool = False
    qkv_bias: bool = False              # biases on q/k/v (Qwen2)
    dtype: torch.dtype = torch.bfloat16  # activation/compute/weight dtype
    param_dtype: torch.dtype = torch.float32  # training's master weights
    remat: bool = True
    # "full": recompute each layer in backward (one more forward of
    # flops, least memory); "dots": keep the outputs of the 2-D weight
    # products and recompute the rest (the flash kernels included);
    # "none": keep every activation
    remat_policy: str = "full"
    # under a mesh with seq > 1: ring attention's chunks through the flash
    # kernels ("ring flash attention") instead of the plain online-softmax
    # ring, the JAX package's default
    ring_flash: bool = False
    # Multi-head Latent Attention (DeepSeek-V2): a shared latent c = h @
    # w_dkv of rank mla_latent_dim replaces the K/V projections; the arena
    # caches c (normed) and one rotated rope key of mla_rope_dim per
    # position, and serving runs the absorbed form (w_uk folded into q,
    # w_uv into the output). n_kv_heads is ignored.
    mla_latent_dim: Optional[int] = None
    mla_rope_dim: int = 64
    # DeepSeek's q_lora_rank: q = q_a_norm(h @ w_qa) @ w_qb; None is the
    # full-rank wq (V2-Lite)
    mla_q_lora_rank: Optional[int] = None
    # sparse MoE (Mixtral): n_experts = 0 is the dense MLP. Training routes
    # with capacity_factor (assignments past it drop); serving with
    # n_experts / n_experts_per_tok, which drops nothing. router_norm_topk
    # renormalizes the chosen experts' probabilities to sum to 1
    n_experts: int = 0
    n_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    router_norm_topk: bool = True
    # DeepSeek-V3 routing: sigmoid scores with an aux-free-balancing
    # correction bias (the leaf "router_bias", updated outside the
    # gradient) and group-limited selection over router_n_group groups,
    # keeping router_topk_group; combine weights scale by
    # routed_scaling_factor. moe.route_top_k_v3 is the exact math
    router_sigmoid_bias: bool = False
    router_n_group: int = 0
    router_topk_group: int = 0
    routed_scaling_factor: float = 1.0
    router_aux_coef: float = 0.02       # load-balance loss coefficient
    router_z_coef: float = 1e-3         # router z-loss coefficient
    # DeepSeek-MoE: this many always-on "shared" experts run as a dense
    # MLP of width n_shared_experts * mlp_dim beside the routed experts
    # (their output is added, the router ignores them). 0: plain MoE/dense
    n_shared_experts: int = 0
    # DeepSeek's first_k_dense_replace: the first k layers use a dense MLP
    # (width dense_prefix_mlp_dim, default mlp_dim) instead of the MoE,
    # stored as a separate "prefix_layers" stack and run before the main
    # layers. MLA only; V2-Lite: 1 dense layer at width 10944
    n_dense_prefix: int = 0
    dense_prefix_mlp_dim: Optional[int] = None

    def prefix_cfg(self) -> "LlamaConfig":
        """Config view of the dense-prefix layers: the same attention, a
        dense MLP at dense_prefix_mlp_dim, n_layers the prefix length."""
        return dataclasses.replace(
            self, n_layers=self.n_dense_prefix, n_experts=0,
            n_shared_experts=0,
            mlp_dim=self.dense_prefix_mlp_dim or self.mlp_dim,
            n_dense_prefix=0, dense_prefix_mlp_dim=None)

    def main_cfg(self) -> "LlamaConfig":
        """Config view of the main (post-prefix) layer stack."""
        if not self.n_dense_prefix:
            return self
        return dataclasses.replace(
            self, n_layers=self.n_layers - self.n_dense_prefix,
            n_dense_prefix=0, dense_prefix_mlp_dim=None)

    @property
    def param_count(self) -> int:
        """Parameters of the tree ``param_shapes`` describes (the JAX
        config's ``param_count``, which the training MFU reads)."""
        return sum(math.prod(s) for _, _, s in leaf_shapes(param_shapes(self)))

    @property
    def deepseek_fields(self) -> list[str]:
        """The DeepSeek-MoE fields this config sets, for the refusals that
        name them (training, tensor parallelism)."""
        return [f for f, on in (
            ("n_shared_experts", self.n_shared_experts),
            ("n_dense_prefix", self.n_dense_prefix),
            ("router_sigmoid_bias", self.router_sigmoid_bias)) if on]

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.embed_dim // self.n_heads

    @property
    def is_mla(self) -> bool:
        return self.mla_latent_dim is not None

    @property
    def sm_scale(self) -> float:
        """The softmax scale: query_pre_attn_scalar^-0.5 when set, else
        head_dim^-0.5, or for MLA (head_dim + rope_dim)^-0.5 times YaRN's
        mscale^2."""
        if self.is_mla:
            return ((self.head_dim_ + self.mla_rope_dim) ** -0.5
                    * yarn_mscale_sq(self))
        base = (self.query_pre_attn_scalar
                if self.query_pre_attn_scalar is not None else self.head_dim_)
        return base ** -0.5

    def layer_windows(self) -> tuple[Optional[int], ...]:
        """The window of each sublayer of one group of
        ``sliding_window_pattern`` layers (the JAX ``layer_windows``):
        layer i attends under ``layer_windows()[i % pattern]``."""
        p = self.sliding_window_pattern
        if self.sliding_window is None:
            return (None,) * p
        if p == 1:
            return (self.sliding_window,)
        return tuple(self.sliding_window if j != p - 1 else None
                     for j in range(p))

    def validate_mla(self) -> None:
        """The JAX config's MLA checks: a dense prefix needs MLA over an
        MoE body and must leave MoE layers, q_lora_rank needs MLA, V3
        routing needs an MoE body and groups that hold its top-k, and MLA
        composes with no window, q/k norm, q/k/v bias, soft cap or query
        scalar. Also an unknown ``mlp_activation`` raises, and a window
        pattern that does not divide the layers (the JAX model's layer
        groups)."""
        if self.mlp_activation not in ("silu", "gelu_tanh"):
            raise ValueError(f"unknown mlp_activation "
                             f"{self.mlp_activation!r}")
        p = self.sliding_window_pattern
        if p < 1 or self.n_layers % p:
            raise ValueError(f"n_layers {self.n_layers} not divisible by "
                             f"sliding_window_pattern {p}")
        if self.n_dense_prefix:
            if not self.is_mla or not self.n_experts:
                raise ValueError("n_dense_prefix models the DeepSeek shape: "
                                 "MLA attention over a MoE body")
            if self.n_dense_prefix >= self.n_layers:
                raise ValueError(f"n_dense_prefix {self.n_dense_prefix} must "
                                 f"leave MoE layers (n_layers "
                                 f"{self.n_layers})")
        if self.mla_q_lora_rank is not None and not self.is_mla:
            raise ValueError("mla_q_lora_rank requires MLA (set "
                             "mla_latent_dim); on a plain-attention config "
                             "the field would silently do nothing")
        if self.router_sigmoid_bias:
            ng, tg = self.router_n_group, self.router_topk_group
            if not self.n_experts:
                raise ValueError("router_sigmoid_bias needs a MoE config "
                                 "(n_experts > 0); on a dense MLP it would "
                                 "silently do nothing")
            if ng <= 0 or tg <= 0 or tg > ng or self.n_experts % ng:
                raise ValueError(
                    f"V3 routing needs 0 < router_topk_group "
                    f"({tg}) <= router_n_group ({ng}) and n_experts "
                    f"({self.n_experts}) divisible by router_n_group")
            if self.n_experts_per_tok > (self.n_experts // ng) * tg:
                raise ValueError(
                    f"n_experts_per_tok {self.n_experts_per_tok} exceeds "
                    f"the {(self.n_experts // ng) * tg} experts the "
                    "group-limited selection keeps eligible")
        if not self.is_mla:
            return
        bad = [f for f, on in (("sliding_window",
                                self.sliding_window is not None),
                               ("qk_norm", self.qk_norm),
                               ("qkv_bias", self.qkv_bias),
                               ("attn_logit_softcap",
                                self.attn_logit_softcap is not None),
                               ("query_pre_attn_scalar",
                                self.query_pre_attn_scalar is not None))
               if on]
        if bad:
            raise ValueError(f"MLA does not compose with {bad} (DeepSeek-V2 "
                             "uses none of them)")

    @property
    def embed_multiplier(self) -> Optional[float]:
        """sqrt(embed_dim) rounded to the compute dtype, the factor the
        JAX model scales embeddings by (``embed_scale``); None without
        it. In bf16 Gemma's sqrt(3072) = 55.43 is 55.5."""
        if not self.embed_scale:
            return None
        return float(torch.tensor(self.embed_dim ** 0.5,
                                  dtype=torch.float64).to(self.dtype))


def yarn_mscale_sq(cfg: LlamaConfig) -> float:
    """YaRN's other half: with ``mscale_all_dim`` in a yarn
    ``rope_scaling``, the softmax scale multiplies by
    (0.1 * mscale_all_dim * ln(factor) + 1)^2, as DeepSeek's own code and
    the JAX package apply it; 1.0 otherwise."""
    sc = cfg.rope_scaling or {}
    rt = sc.get("rope_type", sc.get("type"))
    ms_all = sc.get("mscale_all_dim")
    f = float(sc.get("factor", 1.0))
    if rt != "yarn" or not ms_all or f <= 1:
        return 1.0
    m = 0.1 * float(ms_all) * math.log(f) + 1.0
    return m * m


def llama3_8b() -> LlamaConfig:
    return LlamaConfig(name="llama3-8b", vocab_size=128256, embed_dim=4096,
                       n_layers=32, n_heads=32, n_kv_heads=8, mlp_dim=14336,
                       max_seq_len=8192, rope_theta=500_000.0)


def llama3_70b() -> LlamaConfig:
    return LlamaConfig(name="llama3-70b", vocab_size=128256, embed_dim=8192,
                       n_layers=80, n_heads=64, n_kv_heads=8, mlp_dim=28672,
                       max_seq_len=8192, rope_theta=500_000.0)


def llama31_8b() -> LlamaConfig:
    # Llama-3.1-8B: the 3.0 backbone at 128k context via the NTK-aware
    # frequency warp (ops/rope.py scaling branch)
    return LlamaConfig(name="llama31-8b", vocab_size=128256, embed_dim=4096,
                       n_layers=32, n_heads=32, n_kv_heads=8, mlp_dim=14336,
                       max_seq_len=131072, rope_theta=500_000.0,
                       rope_scaling={"factor": 8.0, "low_freq_factor": 1.0,
                                     "high_freq_factor": 4.0,
                                     "original_max_position": 8192})


def gemma_7b() -> LlamaConfig:
    """Gemma-7B: multi-head attention (16 heads of 256 over 16 kv heads),
    a GeGLU MLP, embeddings scaled by sqrt(embed_dim), zero-centered
    RMSNorm weights and an LM head tied to the embedding."""
    return LlamaConfig(name="gemma-7b", vocab_size=256000, embed_dim=3072,
                       n_layers=28, n_heads=16, n_kv_heads=16, head_dim=256,
                       mlp_dim=24576, max_seq_len=8192, rope_theta=10_000.0,
                       norm_eps=1e-6, tie_embeddings=True,
                       mlp_activation="gelu_tanh", embed_scale=True,
                       norm_zero_centered=True)


def mistral_7b() -> LlamaConfig:
    """Mistral-7B-v0.1: a Llama-shaped GQA decoder (32/8 heads) whose every
    layer attends a 4096-token sliding window."""
    return LlamaConfig(name="mistral-7b", vocab_size=32000, embed_dim=4096,
                       n_layers=32, n_heads=32, n_kv_heads=8, mlp_dim=14336,
                       max_seq_len=32768, rope_theta=10_000.0,
                       sliding_window=4096)


def qwen2_7b() -> LlamaConfig:
    """Qwen2-7B: a GQA decoder (28/4 heads of 128) with biases on its q,
    k and v projections."""
    return LlamaConfig(name="qwen2-7b", vocab_size=152064, embed_dim=3584,
                       n_layers=28, n_heads=28, n_kv_heads=4, mlp_dim=18944,
                       max_seq_len=32768, rope_theta=1_000_000.0,
                       norm_eps=1e-6, qkv_bias=True)


def qwen3_8b() -> LlamaConfig:
    """Qwen3-8B: a GQA decoder (32/8 heads of 128) with a per-head RMSNorm
    on q and k before RoPE."""
    return LlamaConfig(name="qwen3-8b", vocab_size=151936, embed_dim=4096,
                       n_layers=36, n_heads=32, n_kv_heads=8, head_dim=128,
                       mlp_dim=12288, max_seq_len=32768,
                       rope_theta=1_000_000.0, norm_eps=1e-6, qk_norm=True)


def gemma2_9b() -> LlamaConfig:
    """Gemma-2-9B: local (4096) and global layers alternating (even layers
    local), soft caps on attention scores (50) and final logits (30),
    sandwich norms around both sublayers, GQA 16/8 heads of 256."""
    return LlamaConfig(name="gemma2-9b", vocab_size=256000, embed_dim=3584,
                       n_layers=42, n_heads=16, n_kv_heads=8, head_dim=256,
                       mlp_dim=14336, max_seq_len=8192, rope_theta=10_000.0,
                       norm_eps=1e-6, tie_embeddings=True,
                       mlp_activation="gelu_tanh", embed_scale=True,
                       norm_zero_centered=True,
                       sliding_window=4096, sliding_window_pattern=2,
                       attn_logit_softcap=50.0, logit_softcap=30.0,
                       query_pre_attn_scalar=256.0, post_norms=True)


def gemma3_12b() -> LlamaConfig:
    """Gemma-3-12B (text): five local (1024) layers to one global, RoPE
    base 1e4 on local layers and 1e6 with linear x8 scaling on global
    ones, the q/k norm, sandwich norms; no soft caps."""
    return LlamaConfig(name="gemma3-12b", vocab_size=262208, embed_dim=3840,
                       n_layers=48, n_heads=16, n_kv_heads=8, head_dim=256,
                       mlp_dim=15360, max_seq_len=32768,
                       rope_theta=1_000_000.0, rope_local_theta=10_000.0,
                       rope_scaling={"rope_type": "linear", "factor": 8.0},
                       norm_eps=1e-6, tie_embeddings=True,
                       mlp_activation="gelu_tanh", embed_scale=True,
                       norm_zero_centered=True,
                       sliding_window=1024, sliding_window_pattern=6,
                       query_pre_attn_scalar=256.0, post_norms=True,
                       qk_norm=True)


def tiny_llama(**kw) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig(), **kw)


def mixtral_8x7b() -> LlamaConfig:
    """Mixtral-8x7B: Mistral-7B's body (32 layers, E 4096, GQA 32/8, vocab
    32000, rope theta 1e6) with an 8-expert top-2 sparse MLP of width
    14336 in every layer; 46.70 B parameters."""
    return LlamaConfig(name="mixtral-8x7b", vocab_size=32000, embed_dim=4096,
                       n_layers=32, n_heads=32, n_kv_heads=8, mlp_dim=14336,
                       max_seq_len=32768, rope_theta=1_000_000.0,
                       n_experts=8, n_experts_per_tok=2)


def tiny_moe(**kw) -> LlamaConfig:
    """Tiny MoE config for tests and CPU runs: 4 experts, top-2."""
    kw.setdefault("name", "tiny-moe")
    kw.setdefault("n_experts", 4)
    kw.setdefault("n_experts_per_tok", 2)
    return dataclasses.replace(LlamaConfig(), **kw)


def mla_8b() -> LlamaConfig:
    """The MLA geometry the JAX package serves on one chip: Llama-3-8B's
    body (32 layers, E 4096, MLP 14336, vocab 128256) under DeepSeek-V2-Lite
    attention (32 heads of 128, latent 512, rope 64, full-rank q); 8.25 B
    parameters."""
    return LlamaConfig(name="mla-8b", vocab_size=128256, embed_dim=4096,
                       n_layers=32, n_heads=32, n_kv_heads=32,
                       head_dim=128, mla_latent_dim=512, mla_rope_dim=64,
                       mlp_dim=14336, max_seq_len=8192,
                       rope_theta=500_000.0)


def deepseek_v2_lite() -> LlamaConfig:
    """DeepSeek-V2-Lite: MLA (latent 512 plus a decoupled RoPE key of 64,
    16 heads of 128, full-rank q, YaRN x40) over a DeepSeek-MoE MLP (64
    routed experts top-6 without renormalization, 2 shared, each of width
    1408), its first layer dense at 10944 (first_k_dense_replace 1);
    15.71 B parameters. max_seq_len is the checkpoint's
    max_position_embeddings, 163840 = 40 x 4096, the length the YaRN
    tables are scaled for."""
    return LlamaConfig(name="deepseek-v2-lite", vocab_size=102400,
                       embed_dim=2048, n_layers=27, n_heads=16,
                       n_kv_heads=16, head_dim=128, mlp_dim=1408,
                       max_seq_len=163840, rope_theta=10_000.0,
                       rope_scaling={"rope_type": "yarn", "factor": 40.0,
                                     "beta_fast": 32, "beta_slow": 1,
                                     "mscale": 0.707,
                                     "mscale_all_dim": 0.707,
                                     "original_max_position_embeddings":
                                         4096},
                       norm_eps=1e-6,
                       mla_latent_dim=512, mla_rope_dim=64,
                       n_experts=64, n_experts_per_tok=6,
                       n_shared_experts=2, router_norm_topk=False,
                       n_dense_prefix=1, dense_prefix_mlp_dim=10944)


def deepseek_v3() -> LlamaConfig:
    """DeepSeek-V3/R1: the V2 MLA (latent 512 plus rope 64, 128 heads of
    128, low-rank q 1536) with V3's sigmoid-scored, bias-corrected,
    group-limited routing (256 experts top-8, 8 groups keeping 4, scaling
    2.5, renormalized) and 1 shared expert; its first 3 layers dense at
    18432. 671 B parameters, more than one replica serves: the config is
    here so checkpoints convert and tiny-geometry tests hold the math."""
    return LlamaConfig(name="deepseek-v3", vocab_size=129280,
                       embed_dim=7168, n_layers=61, n_heads=128,
                       n_kv_heads=128, head_dim=128, mlp_dim=2048,
                       max_seq_len=163840, rope_theta=10_000.0,
                       rope_scaling={"rope_type": "yarn", "factor": 40.0,
                                     "beta_fast": 32, "beta_slow": 1,
                                     "mscale": 1.0, "mscale_all_dim": 1.0,
                                     "original_max_position_embeddings":
                                         4096},
                       norm_eps=1e-6,
                       mla_latent_dim=512, mla_rope_dim=64,
                       mla_q_lora_rank=1536,
                       n_experts=256, n_experts_per_tok=8,
                       n_shared_experts=1, router_norm_topk=True,
                       router_sigmoid_bias=True, router_n_group=8,
                       router_topk_group=4, routed_scaling_factor=2.5,
                       n_dense_prefix=3, dense_prefix_mlp_dim=18432)


def tiny_mla(**kw) -> LlamaConfig:
    """Tiny MLA config for tests and CPU runs: a dense MLP under latent
    attention."""
    kw.setdefault("name", "tiny-mla")
    kw.setdefault("n_heads", 4)
    kw.setdefault("n_kv_heads", 4)
    kw.setdefault("head_dim", 32)
    kw.setdefault("mla_latent_dim", 64)
    kw.setdefault("mla_rope_dim", 16)
    return dataclasses.replace(LlamaConfig(), **kw)


def _layer_shapes(cfg: LlamaConfig) -> dict:
    e, hd, n, hn = cfg.embed_dim, cfg.head_dim_, cfg.n_layers, cfg.n_heads
    if cfg.is_mla:
        r, dr, qr = cfg.mla_latent_dim, cfg.mla_rope_dim, cfg.mla_q_lora_rank
        if qr is not None:
            attn = {"w_qa": (n, e, qr), "q_a_norm": (n, qr),
                    "w_qb": (n, qr, hn * (hd + dr))}
        else:
            attn = {"wq": (n, e, hn * (hd + dr))}
        attn.update({"w_dkv": (n, e, r + dr), "c_norm": (n, r),
                     "w_uk": (n, r, hn * hd), "w_uv": (n, r, hn * hd)})
    else:
        attn = {"wq": (n, e, hn * hd),
                "wk": (n, e, cfg.n_kv_heads * hd),
                "wv": (n, e, cfg.n_kv_heads * hd)}
    m, x = cfg.mlp_dim, cfg.n_experts
    if x:
        mlp = {"router": (n, e, x), "we_gate": (n, x, e, m),
               "we_up": (n, x, e, m), "we_down": (n, x, m, e)}
        if cfg.router_sigmoid_bias:
            mlp["router_bias"] = (n, x)
        if cfg.n_shared_experts:
            sw = cfg.n_shared_experts * m
            mlp.update({"ws_gate": (n, e, sw), "ws_up": (n, e, sw),
                        "ws_down": (n, sw, e)})
    else:
        mlp = {"w_gate": (n, e, m), "w_up": (n, e, m), "w_down": (n, m, e)}
    if cfg.qk_norm:
        attn.update({"q_norm": (n, hd), "k_norm": (n, hd)})
    if cfg.qkv_bias:
        attn.update({"wq_b": (n, hn * hd), "wk_b": (n, cfg.n_kv_heads * hd),
                     "wv_b": (n, cfg.n_kv_heads * hd)})
    post = ({"attn_post_norm": (n, e), "mlp_post_norm": (n, e)}
            if cfg.post_norms else {})
    return {"attn_norm": (n, e),
            **attn,
            "wo": (n, hn * hd, e),
            "mlp_norm": (n, e),
            **mlp,
            **post}


# the stacked layer groups a tree may hold, in the order they run:
# DeepSeek's dense prefix, then the main layers
STACKS = ("prefix_layers", "layers")


def param_shapes(cfg: LlamaConfig) -> Params:
    """The tree's shapes: ``layers`` the main stack (``main_cfg``), and
    with a dense prefix ``prefix_layers`` its own stack (``prefix_cfg``),
    as the JAX ``init_params`` lays them out."""
    shapes: Params = {"tok_embed": (cfg.vocab_size, cfg.embed_dim),
                      "final_norm": (cfg.embed_dim,),
                      "layers": _layer_shapes(cfg.main_cfg())}
    if cfg.n_dense_prefix:
        shapes["prefix_layers"] = _layer_shapes(cfg.prefix_cfg())
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.embed_dim, cfg.vocab_size)
    return shapes


def leaf_shapes(shapes: Params):
    """(stack or None, leaf name, value) of every leaf of a tree shaped as
    ``param_shapes``' (a stack's leaves under its name, in the tree's
    order)."""
    for name, v in shapes.items():
        if name in STACKS:
            for leaf, s in v.items():
                yield name, leaf, s
        else:
            yield None, name, v


def is_norm(name: str) -> bool:
    return name.endswith("norm")


def is_bias(name: str) -> bool:
    return name in ("wq_b", "wk_b", "wv_b")


def init_fill(cfg: LlamaConfig, name: str) -> Optional[float]:
    """The constant a leaf starts at, as the JAX ``init_params`` sets it:
    a norm's identity (1, or 0 when applied as (1 + w)), a bias and V3's
    router correction bias 0; None for a leaf drawn at random."""
    if is_norm(name):
        return 0.0 if cfg.norm_zero_centered else 1.0
    return 0.0 if is_bias(name) or name == "router_bias" else None


def keeps_f32(name: str) -> bool:
    """Leaves a serving tree keeps in f32: the norms, which RMSNorm applies
    in f32, and the MoE router and its correction bias, which route in
    f32."""
    return is_norm(name) or name in ("router", "router_bias")


# remat "dots": the products whose outputs a layer keeps for backward,
# the 2-D ones (a (B, S, in) @ (in, out) product reaches the dispatcher as
# ``mm``); the batched ``bmm`` and everything else is recomputed, as the
# JAX ``dots_with_no_batch_dims_saveable`` policy keeps only dots without
# batch dimensions. The flash and norm kernels launch outside the
# dispatcher, so the recompute runs them again, as under "full"
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def _mm(h: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """h @ w for a raw weight, an int8 ``{"q8", "scale"}`` leaf (the
    dequant multiply after the matmul), an int4 ``{"q4", "scale"}`` leaf
    (the ``int4_matmul`` kernel) or a LoRA leaf ``{"w", "lora_a",
    "lora_b", "scale"}``: the base weight detached (the JAX model's
    ``stop_gradient``), so gradients reach A and B only."""
    if isinstance(w, dict):
        if "lora_a" in w:
            base = h @ w["w"].detach().to(dtype)
            delta = (h @ w["lora_a"].to(dtype)) @ w["lora_b"].to(dtype)
            return base + delta * w["scale"].to(dtype)
        if "q4" in w:
            return int4_matmul(h.to(dtype), w["q4"], w["scale"])
        return (h @ w["q8"].to(dtype)) * w["scale"].to(dtype)
    return h @ w if w.dtype == dtype else h @ w.to(dtype)


def _ml_delta(x: torch.Tensor, ad: dict, ids: torch.Tensor) -> torch.Tensor:
    """The multi-LoRA delta with an adapter chosen per row (the JAX
    ``_ml_delta``): x (B, S, in), one layer's ``ad`` {"a": (N, in, r), "b":
    (N, r, out), "scale": (N,)}, ids (B,) into the adapter axis. Each row's
    A and B are gathered, the two products run in x's dtype, then the
    row's scale multiplies. Slot 0 is all zeros, so a base row needs no
    branch."""
    a_sel = ad["a"][ids].to(x.dtype)                   # (B, in, r)
    b_sel = ad["b"][ids].to(x.dtype)                   # (B, r, out)
    d = torch.bmm(torch.bmm(x, a_sel), b_sel)
    return d * ad["scale"][ids].to(x.dtype)[:, None, None]


def _layer_adapters(adapters: Optional[dict], layer: int) -> Optional[dict]:
    """Layer ``layer`` of the adapter stacks, or None without adapters."""
    if not adapters:
        return None
    return {t: {k: v[layer] for k, v in ad.items()}
            for t, ad in adapters.items()}


def _mm_tp(h: torch.Tensor, w, kind: str, mesh, dtype: torch.dtype
           ) -> torch.Tensor:
    """h (..., in) @ a leaf split over ``mesh``'s tensor axis, whole: for
    ``kind`` "col" (out split) the shards' outputs gathered in shard order,
    for "row" (contraction split) their partial sums added, the psum that
    follows a row-parallel product. An int4 leaf is out-split whatever its
    base weight (``int4_matmul_sharded``); an int8 leaf's scale multiplies
    the whole product, its own shard's columns or the summed rows. In one
    process w stacks the shards on its leading axis; over a process group
    it is the rank's slice and the collectives run over the group."""
    if isinstance(w, dict) and "q4" in w:
        return int4_matmul_sharded(h.to(dtype), w["q4"], w["scale"], mesh)
    q8 = isinstance(w, dict)
    wt = (w["q8"] if q8 else w).to(dtype)
    h2 = h.reshape(-1, h.shape[-1])
    if kind == "col":
        if mesh.in_process:
            y = torch.matmul(h2, wt)                   # (N, M, out/N)
            if q8:
                y = y * w["scale"].to(dtype)
            y = y.transpose(0, 1).reshape(h2.shape[0], -1)
        else:
            y = h2 @ wt
            if q8:
                y = y * w["scale"].to(dtype)
            y = all_gather(y, -1, mesh)
    else:
        k = h2.shape[1] // mesh.tensor
        if mesh.in_process:
            y = torch.matmul(h2.view(-1, mesh.tensor, k).transpose(0, 1),
                             wt).sum(0)
        else:
            y = all_reduce(h2[:, mesh.rank * k:(mesh.rank + 1) * k] @ wt,
                           mesh)
        if q8:
            y = y * w["scale"].to(dtype)
    return y.reshape(*h.shape[:-1], y.shape[-1])


def _at(w, layer: int):
    """Layer ``layer`` of a stacked leaf, raw or quantized."""
    if isinstance(w, dict):
        return {k: v[layer] for k, v in w.items()}
    return w[layer]


def _kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 rows over the last (head_dim) axis: (..., d) ->
    (int8 (..., d), f32 scale (...,))."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


def _write_rows(dst: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor,
                new: torch.Tensor, write: torch.Tensor) -> None:
    """dst[rows, slots] = new where ``write`` (B, K), else left as it is:
    a gather and a scatter at fixed shapes, no host sync (the JAX model's
    ``where(active, new, old)`` writes)."""
    keep = write.view(*write.shape, *(1,) * (new.dim() - write.dim()))
    dst[rows, slots] = torch.where(keep, new.to(dst.dtype), dst[rows, slots])


def _shard_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rows (B, K, Hkv, ...) of every kv head -> (N, B, K, Hkv/N, ...), each
    shard's own heads (x itself when ``n`` is 1): the split of a
    head-sharded contiguous cache, shard s holding heads s·h .. (s+1)·h."""
    return x if n == 1 else x.unflatten(2, (n, -1)).movedim(2, 0)


def _write_shards(dst: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor,
                  new: torch.Tensor, write: torch.Tensor, n: int) -> None:
    """``_write_rows`` into one layer of a contiguous cache section: (B, L,
    ...) whole, or (N, B, L, h, ...) head-sharded with ``new`` from
    ``_shard_heads``, each shard into its own heads."""
    if n == 1:
        _write_rows(dst, rows, slots, new, write)
        return
    for shard in range(n):
        _write_rows(dst[shard], rows, slots, new[shard], write)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, master: bool = False) -> Params:
    """Random init from ``generator`` (normal * 0.02; norms at identity and
    q/k/v biases at 0, ``init_fill``), built directly on ``device``
    (default ``cuda``) one layer at a time, so the f32 draw never holds
    more than one layer's leaf. ``generator`` must
    live on that device. Weights are in ``cfg.dtype`` (serving), or in
    ``cfg.param_dtype`` with ``master=True`` (training); the same generator
    draws the same values, so the serving weights are the master weights
    rounded (the router stays f32 in both)."""
    cfg.validate_mla()
    dev = resolve_device(device)
    dtype = cfg.param_dtype if master else cfg.dtype

    def make(name: str, shape) -> torch.Tensor:
        out = torch.empty(shape, dtype=torch.float32 if keeps_f32(name)
                          else dtype, device=dev)
        fill = init_fill(cfg, name)
        if fill is not None:
            return out.fill_(fill)
        for at, row in draw_rows(shape, generator, dev):
            out[at] = row
        return out

    params: Params = {}
    for stack, name, s in leaf_shapes(param_shapes(cfg)):
        if stack is None:
            params[name] = make(name, s)
        else:
            params.setdefault(stack, {})[name] = make(name, s)
    return params


def draw_rows(shape, generator: torch.Generator, device):
    """The draws of one non-norm leaf, as ``init_params`` makes them: a
    stacked (L, ...) leaf of more than two axes one row a layer, any other
    leaf one row; each row drawn flat, f32 normal * 0.02. Yields (index of
    the row in the leaf, the row in its shape there)."""
    stacked = len(shape) > 2
    part = tuple(shape[1:]) if stacked else tuple(shape)
    for i in range(shape[0] if stacked else 1):
        # in place and held by no local: the caller frees a row before the
        # next is drawn
        yield ((i,) if stacked else ()), torch.randn(
            (math.prod(part),), generator=generator, device=device,
            dtype=torch.float32).mul_(0.02).view(part)


class LlamaModel:
    """The contiguous forward (training) and the paged serving steps over a
    per-model arena. ``device`` defaults to ``cuda`` and raises without a
    card. ``mesh`` (``parallel.Mesh``) with seq > 1 sends the forward's
    attention through ``ring_attention``, as the JAX model does under a
    mesh with a ``seq`` axis; with tensor > 1 every step runs
    tensor-parallel over a tree from ``parallel.shard_params`` (the module
    docstring); an ``expert`` axis beside it shards the serving steps'
    expert FFN (``moe_mlp(mesh=)``; training passes none, as in JAX). MLA
    and DeepSeek-MoE configs raise under tensor > 1."""

    def __init__(self, cfg: LlamaConfig, device=None, mesh=None):
        cfg.validate_mla()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.tp = mesh.tensor if mesh is not None else 1
        check_tensor_parallel(cfg, self.tp)
        check_expert_parallel(cfg, mesh.expert if mesh is not None else 1)
        # "col" (out split) or "row" (contraction split) for each matmul
        # leaf the tensor axis splits
        self._split = {"lm_head": "col"}
        for name, ax in param_logical_axes(cfg)["layers"].items():
            i = tensor_axis(ax)
            if i is not None:
                self._split[name] = "col" if i == len(ax) - 1 else "row"
        # MLA rotates only the decoupled rope part of q and its shared key
        rope_dim = cfg.mla_rope_dim if cfg.is_mla else cfg.head_dim_
        self.cos, self.sin = rope_frequencies(
            rope_dim, cfg.max_seq_len, cfg.rope_theta, cfg.rope_scaling,
            device=self.device)
        # the windowed layers' table (the JAX ``_rope_tables``): Gemma 3's
        # local base with no scaling, else the global table itself
        self.cos_local, self.sin_local = (
            (self.cos, self.sin) if cfg.rope_local_theta is None else
            rope_frequencies(rope_dim, cfg.max_seq_len, cfg.rope_local_theta,
                             None, device=self.device))
        self._windows = cfg.layer_windows()
        # the kv-head shards of the contiguous caches this model lays out
        # (the arena's rule, ``paged_head_shards``; 1: whole heads)
        self.cache_head_shards = (
            paged_head_shards(self.tp, cfg.n_heads, cfg.n_kv_heads)
            if mesh is not None and mesh.in_process and not cfg.is_mla
            else 1)

    def stack_layout(self) -> list[tuple[str, int, str]]:
        """(tree key, layer count, cache and arena section suffix) of each
        layer stack in the order the layers run: DeepSeek's dense prefix
        (``prefix_layers``, its sections ``c_pre``/``kr_pre``) first, then
        the main layers."""
        k = self.cfg.n_dense_prefix
        return (([("prefix_layers", k, "_pre")] if k else [])
                + [("layers", self.cfg.n_layers - k, "")])

    def stacks(self, params: Params) -> list[tuple[Params, int, str]]:
        """``stack_layout`` with each stack's leaves in place of its key."""
        return [(params[key], n, sfx) for key, n, sfx in self.stack_layout()]

    def _stack_layers(self, params: Params):
        """(stacked leaves, layer within them, section suffix) of every
        layer, in the order they run."""
        for lp, n, sfx in self.stacks(params):
            for layer in range(n):
                yield lp, layer, sfx

    def window(self, layer: int) -> Optional[int]:
        """Layer ``layer``'s attention window (None: full causal)."""
        return self._windows[layer % len(self._windows)]

    def rope(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer ``layer``'s RoPE table (the JAX ``_rope_for``): the local
        one on a windowed layer, the global one otherwise."""
        return self._rope_for(self.window(layer))

    def _rope_for(self, window: Optional[int]):
        if window is None:
            return self.cos, self.sin
        return self.cos_local, self.sin_local

    def _post_norm(self, y: torch.Tensor, leaf, name: str) -> torch.Tensor:
        """A sublayer's output through its sandwich norm (``leaf(name)``,
        ``attn_post_norm`` or ``mlp_post_norm``) with ``post_norms``; y
        itself otherwise."""
        if not self.cfg.post_norms:
            return y
        return rms_norm(y, self._norm_w(leaf(name)), self.cfg.norm_eps)

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                train: bool = True, with_aux: bool = False):
        """tokens (B, S) -> logits (B, S, V) in ``cfg.dtype``, or with
        ``return_hidden`` the final-norm hidden states (B, S, E); with
        ``with_aux`` the pair (that, aux), aux the f32 sum over the routed
        layers of ``router_aux_coef`` x load-balance loss + ``router_z_coef``
        x z-loss (the JAX ``forward(with_aux=True)``: 0 for a dense layer
        and under V3's sigmoid routing), the term a trainer adds to its
        loss. Every
        layer is causal flash attention (under the layer's window) and a
        SwiGLU or GeGLU MLP (or the sparse MoE
        MLP, routed at ``cfg.capacity_factor``, or with ``train=False`` at
        the serving capacity that drops nothing), each behind an RMSNorm;
        weights are cast to ``cfg.dtype`` at each use. Under remat
        "full" each layer is a ``torch.utils.checkpoint`` (the counterpart
        of ``jax.checkpoint`` over the JAX model's scan body), so backward
        runs its forward once more; under "dots" the checkpoint is
        selective (``_dots_context``, the JAX
        ``dots_with_no_batch_dims_saveable``): the outputs of the 2-D
        products are kept and everything else, the flash kernels and the
        norms included, runs again. ``positions`` (B, S) overrides arange
        for RoPE. Under a mesh with seq > 1 attention is ring attention
        over the sequence shards (in one process the tokens are the whole
        sequence; over a process group they are this rank's shard, whose
        positions start at rank * S). An MLA layer runs the direct form
        (``_mla_attention``)."""
        cfg = self.cfg
        if cfg.remat and cfg.remat_policy not in ("full", "dots", "none"):
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        mesh = self.mesh
        if positions is None and mesh is not None and not mesh.in_process:
            b, s = tokens.shape
            positions = (mesh.rank * s + torch.arange(
                s, device=tokens.device)).expand(b, s)
        x = self._embed(params, tokens)
        remat = cfg.remat and cfg.remat_policy != "none"
        context = ({"context_fn": _dots_context}
                   if cfg.remat_policy == "dots" else {})
        aux = (torch.zeros((), dtype=torch.float32, device=x.device)
               if with_aux else None)
        for stack, n, _ in self.stacks(params):
            # one unbind per stacked leaf: its backward stacks the layer
            # gradients once (a quantized leaf is sliced per layer)
            layers = {name: ([_at(leaf, i) for i in range(n)]
                             if isinstance(leaf, dict) else leaf.unbind(0))
                      for name, leaf in stack.items()}
            for i in range(n):
                lp = {name: leaves[i] for name, leaves in layers.items()}
                kw = dict(train=train, layer=i, with_aux=with_aux)
                if remat:
                    out = torch.utils.checkpoint.checkpoint(
                        self._layer, x, lp, positions, use_reentrant=False,
                        **context, **kw)
                else:
                    out = self._layer(x, lp, positions, **kw)
                if with_aux:
                    x, layer_aux = out
                    aux = aux + layer_aux
                else:
                    x = out
        x = rms_norm(x, self._norm_w(params["final_norm"]), cfg.norm_eps)
        out = x if return_hidden else self._lm_head(params, x)
        return (out, aux) if with_aux else out

    def _layer(self, x: torch.Tensor, lp: Params,
               positions: Optional[torch.Tensor],
               return_kv: bool = False, train: bool = True,
               ad: Optional[dict] = None,
               ids: Optional[torch.Tensor] = None, layer: int = 0,
               with_aux: bool = False):
        """Decoder layer ``layer`` of ``forward``: the JAX model's dense
        ``_attention_block`` (or for MLA ``_mla_attention_block``) then
        ``_mlp_block``, the matmuls through ``_mm`` (raw weights cast to
        ``cfg.dtype``, or quantized leaves), under the layer's window and
        RoPE table, each sublayer's output through its sandwich norm with
        ``post_norms``. ``return_kv`` also returns the
        layer's cache content: the rotated k and v (B, S, Hkv, D), or for
        MLA the normed latent c (B, S, r) and rotated rope key kr (B, S,
        dr). ``ad`` (one layer's adapter stacks) and ``ids`` (B,) add each
        row's multi-LoRA deltas. ``with_aux`` returns (x, the layer's
        scaled router aux, ``_mlp``'s) instead of x (not with
        ``return_kv``)."""
        cfg = self.cfg
        if cfg.is_mla:
            x, c, kr = self._mla_attention(x, lp, positions)
            x = self._mlp(x, lp, train, with_aux=with_aux)
            return (x, c, kr) if return_kv else x
        b, s, _ = x.shape
        hd = cfg.head_dim_
        window = self.window(layer)
        h = rms_norm(x, self._norm_w(lp["attn_norm"]), cfg.norm_eps)
        q, k, v = self._qkv(h, lp.__getitem__, ad, ids, positions,
                            self.rope(layer))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if self.mesh is not None and self.mesh.seq > 1:
            o = ring_attention(qt, kt, vt, self.mesh, causal=True,
                               sm_scale=cfg.sm_scale,
                               logit_soft_cap=cfg.attn_logit_softcap,
                               sliding_window=window,
                               use_flash=cfg.ring_flash)
        else:
            o = self._flash(qt, kt, vt, window)
        o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
        o = self._post_norm(self._proj(o, lp["wo"], "wo", ad, ids),
                            lp.__getitem__, "attn_post_norm")
        x = self._mlp(x + o, lp, train, ad, ids, with_aux)
        return (x, k, v) if return_kv else x

    def _mla_attention(self, x: torch.Tensor, lp: Params,
                       positions: Optional[torch.Tensor]):
        """Port of the JAX ``_mla_attention_block``, MLA's direct form for
        the contiguous forward and prefill, on one layer's leaves: per-head
        k_nope = c w_uk and v = c w_uv from the normed latent, the shared
        rotated key concatenated onto every head's k and v zero-padded to
        the q/k width (head_dim + rope_dim), so the two-part score
        q_nope.k_nope + q_rope.kr is one dot product at that width: the
        flash kernels (one kv head a q head), or under a mesh with seq > 1
        ring attention. The output's first head_dim columns go through
        ``wo``. Returns (x + attention, c (B, S, r), kr (B, S, dr))."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd, dr, hn, dt = (cfg.head_dim_, cfg.mla_rope_dim, cfg.n_heads,
                          cfg.dtype)
        h = rms_norm(x, self._norm_w(lp["attn_norm"]), cfg.norm_eps)
        q_nope, q_rope, c, kr = self._mla_project(h, lp, None, positions)
        k_nope = _mm(c, lp["w_uk"], dt).reshape(b, s, hn, hd)
        v = _mm(c, lp["w_uv"], dt).reshape(b, s, hn, hd)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(b, s, hn, dr)],
                      dim=-1)
        v = torch.cat([v, v.new_zeros((b, s, hn, dr))], dim=-1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if self.mesh is not None and self.mesh.seq > 1:
            o = ring_attention(qt, kt, vt, self.mesh, causal=True,
                               sm_scale=cfg.sm_scale,
                               use_flash=cfg.ring_flash)
        else:
            o = self._flash(qt, kt, vt)
        o = o.transpose(1, 2)[..., :hd].reshape(b, s, hn * hd)
        o = self._post_norm(self._proj(o, lp["wo"], "wo"), lp.__getitem__,
                            "attn_post_norm")
        return x + o, c, kr

    def _flash(self, qt, kt, vt, window: Optional[int] = None
               ) -> torch.Tensor:
        """Causal flash attention of (B, H, S, D) heads, under ``window``
        and the config's score soft cap; in one process
        under a tensor mesh whose degree divides both head counts, one
        launch per shard on its q-head block and kv-head block, as each
        shard runs it."""
        cfg = self.cfg
        n = (paged_head_shards(self.tp, cfg.n_heads, cfg.n_kv_heads)
             if self.mesh is not None and self.mesh.in_process else 1)
        kw = dict(causal=True, sm_scale=cfg.sm_scale, sliding_window=window,
                  logit_soft_cap=cfg.attn_logit_softcap)
        if n == 1:
            return flash_attention(qt, kt, vt, **kw)
        hq, hk = cfg.n_heads // n, cfg.n_kv_heads // n
        return torch.cat([flash_attention(
            qt[:, s * hq:(s + 1) * hq].contiguous(),
            kt[:, s * hk:(s + 1) * hk].contiguous(),
            vt[:, s * hk:(s + 1) * hk].contiguous(), **kw)
            for s in range(n)], dim=1)

    def _proj(self, h: torch.Tensor, w, name: str, ad: Optional[dict] = None,
              ids: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h @ leaf ``name`` (raw or quantized, one layer's) in the compute
        dtype: ``_mm``, or under a tensor mesh ``_mm_tp`` for a leaf the
        tensor axis splits. Then ``bias`` (one layer's, cast to the compute
        dtype; under a tensor mesh the whole bias, added after the
        shards' outputs are gathered), then, when ``ad`` (one layer's
        adapter stacks) holds ``name``, each row's multi-LoRA delta: the
        JAX model's order (``_qkv``, then ``_ml_qkv_deltas``)."""
        dt = self.cfg.dtype
        kind = self._split.get(name) if self.tp > 1 else None
        if kind is None:
            y = _mm(h, w, dt)
        else:
            y = _mm_tp(h, w, kind, self.mesh, dt)
        if bias is not None:
            if self.tp > 1:
                # split like its product's columns: (N, out/N) in one
                # process, the rank's (out/N,) over a process group
                bias = (bias.reshape(-1) if self.mesh.in_process
                        else all_gather(bias, -1, self.mesh))
            y = y + bias.to(dt)
        if ad is not None and name in ad:
            y = y + _ml_delta(h, ad[name], ids)
        return y

    def _qkv(self, h: torch.Tensor, leaf, ad: Optional[dict],
             ids: Optional[torch.Tensor], positions, rope):
        """The JAX model's dense q/k/v path on normed h (B, S, E): the three
        products and their biases (``_qkv``), each row's multi-LoRA deltas
        (``_ml_qkv_deltas``), the per-head q/k RMSNorm (``qk_norm``), then
        RoPE at ``positions`` from ``rope`` (cos, sin), the layer's table.
        ``leaf(name)`` is one layer's leaf. Returns q (B, S, H, hd) and k,
        v (B, S, Hkv, hd)."""
        cfg = self.cfg
        b, s, _ = h.shape
        out = []
        for name, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)):
            bias = leaf(name + "_b") if cfg.qkv_bias else None
            out.append(self._proj(h, leaf(name), name, ad, ids, bias)
                       .reshape(b, s, heads, cfg.head_dim_))
        q, k, v = out
        if cfg.qk_norm:
            q = rms_norm(q, self._norm_w(leaf("q_norm")), cfg.norm_eps)
            k = rms_norm(k, self._norm_w(leaf("k_norm")), cfg.norm_eps)
        cos, sin = rope
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        return q, k, v

    def _norm_w(self, w: torch.Tensor) -> torch.Tensor:
        """The weight an RMSNorm applies: w, or (1 + w) in f32 when the
        config stores its norms zero-centered (Gemma; the JAX
        ``_norm_w``)."""
        return w + 1 if self.cfg.norm_zero_centered else w

    def _check_adapters(self, adapters: Optional[dict],
                        adapter_ids: Optional[torch.Tensor]
                        ) -> Optional[torch.Tensor]:
        """The JAX model's refusals of adapters it cannot apply (MLA; the
        dense MLP's targets on an MoE model), and ``adapter_ids`` as the
        index the gathers take (None without adapters)."""
        if not adapters:
            return None
        if self.cfg.is_mla:
            raise ValueError("multi-LoRA adapters do not target MLA "
                             "projections; serve MLA models without "
                             "adapters")
        if self.cfg.n_experts and set(adapters) & {"w_gate", "w_up",
                                                   "w_down"}:
            raise ValueError("MoE configs have no dense mlp weights to "
                             "adapt; use attention targets")
        if adapter_ids is None:
            raise ValueError("adapters need adapter_ids, one slot a row")
        return adapter_ids.long()

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens`` in the compute dtype, times
        ``cfg.embed_multiplier`` with ``embed_scale``. Under a tensor mesh
        each shard gathers from its own vocab rows, other rows zero, and
        the shards' rows add up: the JAX model's one-hot contraction over a
        vocab-sharded table, exactly."""
        x = self._embed_rows(params["tok_embed"], tokens)
        mult = self.cfg.embed_multiplier
        # the JAX model multiplies by sqrt(E) rounded to the compute dtype
        return x if mult is None else x * mult

    def _embed_rows(self, table: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        tok = tokens.long()
        if self.tp == 1:
            return table[tok].to(dt)

        def part(t: torch.Tensor, shard: int) -> torch.Tensor:
            local = tok - shard * t.shape[0]
            ok = (local >= 0) & (local < t.shape[0])
            rows = t[local.clamp(0, t.shape[0] - 1)].to(dt)
            return torch.where(ok[..., None], rows,
                               torch.zeros((), dtype=dt, device=rows.device))

        if not self.mesh.in_process:
            return all_reduce(part(table, self.mesh.rank), self.mesh)
        x = part(table[0], 0)
        for shard in range(1, self.tp):
            x = x + part(table[shard], shard)
        return x

    def _lm_head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Logits of final-norm states x in the compute dtype: the LM head,
        or the embedding's transpose when tied; under a tensor mesh the
        shards' vocab slices gathered. With ``logit_softcap`` they pass
        cap * tanh(l / cap) in the compute dtype, as the JAX model's
        ``_head_logits`` caps them before any f32 cast."""
        cfg = self.cfg
        if not cfg.tie_embeddings:
            logits = self._proj(x, params["lm_head"], "lm_head")
        else:
            table = params["tok_embed"].transpose(-1, -2)
            logits = (_mm(x, table, cfg.dtype) if self.tp == 1
                      else _mm_tp(x, table, "col", self.mesh, cfg.dtype))
        if cfg.logit_softcap:
            cap = cfg.logit_softcap
            logits = torch.tanh(logits / cap) * cap
        return logits

    # -- contiguous serving steps -------------------------------------------

    def _cache_sections(self) -> tuple[str, str]:
        """The two per-position sections of a contiguous cache: k and v,
        or MLA's latent c and rope key kr."""
        return ("c", "kr") if self.cfg.is_mla else ("k", "v")

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   quantize: bool = False) -> Params:
        """A contiguous KV cache with per-row write indices (the JAX
        model's ``init_cache``/``_empty_cache``): ``k``/``v`` (L, B, S,
        Hkv, D) in the compute dtype, or int8 with ``quantize`` plus
        ``k_scale``/``v_scale`` (L, B, S, Hkv) f32, and ``index`` (B,)
        int32, the committed length of each row. An MLA config gets the
        latent layout: ``c`` (L, B, S, r) and ``kr`` (L, B, S, dr), or int8
        plus ``c_scale``/``kr_scale`` (L, B, S) f32; with a dense prefix
        of kpre layers the main sections hold L - kpre layers and the
        prefix has its own ``c_pre``/``kr_pre`` (kpre, B, S, ...) (and
        ``c_pre_scale``/``kr_pre_scale``), the JAX ``_empty_cache``.

        Under an in-process tensor mesh whose degree N divides both head
        counts (``cache_head_shards``) each K/V section is laid out per
        shard, as the arena is: (N·L, B, S, Hkv/N, D) and scales (N·L, B,
        S, Hkv/N), shard s's layers first at s·L holding kv heads s·h ..
        (s+1)·h (the JAX ``kv_cache_pspec`` split); ``index`` stays
        whole."""
        cfg = self.cfg
        length = max_len or cfg.max_seq_len
        dt = torch.int8 if quantize else cfg.dtype
        ns = self.cache_head_shards
        cache: Params = {}
        for _, n, suffix in self.stack_layout():
            lead = (n, batch, length)
            if cfg.is_mla:
                rows = (lead + (cfg.mla_latent_dim,),
                        lead + (cfg.mla_rope_dim,))
                scales = lead
            else:
                lead = (ns * n, batch, length)
                rows = 2 * (lead + (cfg.n_kv_heads // ns, cfg.head_dim_),)
                scales = lead + (cfg.n_kv_heads // ns,)
            for name, shape in zip(self._cache_sections(), rows):
                cache[name + suffix] = torch.zeros(shape, dtype=dt,
                                                   device=self.device)
                if quantize:
                    cache[name + suffix + "_scale"] = torch.zeros(
                        scales, dtype=torch.float32, device=self.device)
        cache["index"] = torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)
        return cache

    def _abs_pos(self, batch: int, ring_len: int) -> torch.Tensor:
        return torch.full((batch, ring_len), -1, dtype=torch.int32,
                          device=self.device)

    def _check_ring_len(self, ring_len: int) -> None:
        if ring_len <= self.cfg.sliding_window:
            raise ValueError(f"ring_len {ring_len} must exceed the window "
                             f"{self.cfg.sliding_window} (write slack)")

    def init_ring_cache(self, batch: int, ring_len: int,
                        quantize: bool = False) -> Params:
        """A ring cache for a uniformly windowed model (the JAX
        ``init_ring_cache``): ``init_cache``'s sections at ``ring_len``
        positions whatever the sequence length, position p in slot p %
        ring_len, and ``abs_pos`` (B, R) int32, the position each slot
        holds (-1: empty), which attention masks on. ``ring_len`` must
        exceed the window by the most tokens one call writes, so no call
        overwrites a slot some query still sees."""
        cfg = self.cfg
        if cfg.sliding_window is None or cfg.sliding_window_pattern != 1:
            raise ValueError("ring cache requires a uniform sliding_window "
                             "(pattern 1); global-attention layers need the "
                             "full history")
        self._check_ring_len(ring_len)
        cache = self.init_cache(batch, ring_len, quantize)
        cache["abs_pos"] = self._abs_pos(batch, ring_len)
        return cache

    def init_mixed_cache(self, batch: int, max_len: int, ring_len: int,
                         quantize: bool = False) -> Params:
        """The split cache of a local/global interleave (Gemma 2 and 3; the
        JAX ``init_mixed_cache``): ``k_l``/``v_l`` (n_local, B, R, Hkv, D)
        rings for the windowed layers in layer-group order (group g's local
        layers are rows g * (p - 1) ...), ``k_g``/``v_g`` (n_global, B,
        max_len, Hkv, D) for the global ones, one ``abs_pos`` (B, R) every
        local layer shares, and ``index``. ``quantize`` stores every
        section int8 with f32 scales ``k_l_scale``, ``v_l_scale``,
        ``k_g_scale`` and ``v_g_scale``. The ring's write slack is
        ``init_ring_cache``'s. Under a tensor mesh the sections are laid
        out per shard as ``init_cache``'s, (N·n_local, B, R, Hkv/N, D) and
        (N·n_global, B, max_len, Hkv/N, D)."""
        cfg = self.cfg
        p = cfg.sliding_window_pattern
        if cfg.sliding_window is None or p <= 1:
            raise ValueError("mixed cache requires a windowed interleave "
                             "(sliding_window set and pattern > 1); use "
                             "init_ring_cache/init_cache instead")
        self._check_ring_len(ring_len)
        n_groups = cfg.n_layers // p
        ns = self.cache_head_shards
        h, d = cfg.n_kv_heads // ns, cfg.head_dim_
        dt = torch.int8 if quantize else cfg.dtype
        lead = {"_l": (ns * n_groups * (p - 1), batch, ring_len),
                "_g": (ns * n_groups, batch, max_len)}
        cache: Params = {}
        for suffix, shape in lead.items():
            for name in ("k", "v"):
                cache[name + suffix] = torch.zeros(shape + (h, d), dtype=dt,
                                                   device=self.device)
                if quantize:
                    cache[name + suffix + "_scale"] = torch.zeros(
                        shape + (h,), dtype=torch.float32,
                        device=self.device)
        cache["index"] = torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)
        cache["abs_pos"] = self._abs_pos(batch, ring_len)
        return cache

    def cache_shards(self, cache: Params) -> int:
        """The kv-head shards of a contiguous cache from ``init_cache``,
        ``init_ring_cache`` or ``init_mixed_cache``: N when laid out per
        shard, 1 when whole (or headless, MLA)."""
        first = cache.get("k", cache.get("k_l"))
        return 1 if first is None else self.cfg.n_kv_heads // first.shape[-2]

    def _layer_cache(self, cache: Params, layer: int, stack: str = ""):
        """Layer ``layer``'s part of a contiguous cache: (its two sections
        (B, S, ...), or (N, B, S, ...) shard by shard when the cache is
        head-sharded, their scales or Nones, whether it ring-addresses).
        A mixed cache's local layers read its rings in layer-group order,
        its global layers the full-length sections; ``stack`` is the
        suffix of a layer stack's own sections (``_pre``, the dense
        prefix's)."""
        suffix, row, ring = stack, layer, "abs_pos" in cache
        if "k_l" in cache:
            p = self.cfg.sliding_window_pattern
            group, j = divmod(layer, p)
            suffix, row, ring = (("_g", group, False) if j == p - 1 else
                                 ("_l", group * (p - 1) + j, True))
        names = [n + suffix for n in self._cache_sections()]
        ns = self.cache_shards(cache)

        def at(t: torch.Tensor) -> torch.Tensor:
            return t[row] if ns == 1 else t.view(ns, -1, *t.shape[1:])[:, row]

        scales = [at(cache[n + "_scale"]) if n + "_scale" in cache
                  else None for n in names]
        return [at(cache[n]) for n in names], scales, ring

    @staticmethod
    def _fill_head(dst: torch.Tensor, rows: torch.Tensor, n: int) -> None:
        """Rows (B, S, ...) into positions 0 .. S of one layer's section
        (``_layer_cache``'s view), each shard's heads into its own."""
        if n == 1:
            dst[:, :rows.shape[1]] = rows
        else:
            dst[:, :, :rows.shape[1]] = _shard_heads(rows, n)

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params,
                true_length: Optional[torch.Tensor] = None,
                adapters: Optional[dict] = None,
                adapter_ids: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, Params]:
        """A prompt through the contiguous layers into ``cache``, which it
        fills in place from position 0: tokens (B, S) -> (logits of each
        row's last real token (B, V) f32, cache with ``index`` =
        ``true_length``). Attention is the causal flash kernel
        (``flash_attention``) under each layer's window, as in the JAX
        model; an int8 cache stores
        each row through ``_kv_quant``, the paged steps' scheme, so pages
        filled from it equal pages the paged chunk step writes. Padding
        past ``true_length`` writes K/V that nothing attends. A ring or
        mixed cache takes position p < S in slot p, and ``abs_pos`` names
        the real positions only. An MLA model
        runs its direct form (``_mla_attention``, the flash kernels at
        head_dim + rope_dim) and caches each layer's latent c and rope key
        kr. ``adapters``/``adapter_ids`` add each row's multi-LoRA
        deltas."""
        cfg = self.cfg
        b, s = tokens.shape
        ids = self._check_adapters(adapters, adapter_ids)
        if "k_l" in cache:
            ring, max_g = cache["k_l"].shape[2], cache["k_g"].shape[2]
            if s > ring or s > max_g:
                raise ValueError(f"prompt chunk {s} exceeds cache sections "
                                 f"(ring {ring}, global {max_g})")
        else:
            length = cache[self._cache_sections()[0]].shape[2]
            if s > length:
                raise ValueError(f"prompt length {s} exceeds cache length "
                                 f"{length}")
        if true_length is None:
            true_length = torch.full((b,), s, dtype=torch.int32,
                                     device=tokens.device)
        ns = self.cache_shards(cache)
        x = self._embed(params, tokens)
        for lp, n, stack in self.stacks(params):
            for layer in range(n):
                x, *rows = self._layer(
                    x, {k: _at(w, layer) for k, w in lp.items()}, None,
                    return_kv=True, train=False,
                    ad=_layer_adapters(adapters, layer), ids=ids,
                    layer=layer)
                sections, scales, _ = self._layer_cache(cache, layer, stack)
                for dst, dst_s, row in zip(sections, scales, rows):
                    if dst_s is not None:
                        row, row_s = _kv_quant(row)
                        self._fill_head(dst_s, row_s, ns)
                    self._fill_head(dst, row, ns)
        tl = true_length.to(torch.int32)
        cache["index"].copy_(tl)
        if "abs_pos" in cache:
            slot_ids = torch.arange(cache["abs_pos"].shape[1],
                                    device=tl.device, dtype=torch.int32)
            cache["abs_pos"].copy_(torch.where(
                slot_ids[None, :] < tl[:, None], slot_ids[None, :], -1))
        last = x[torch.arange(b, device=x.device),
                 true_length.long() - 1][:, None]
        return self._head_logits(params, last)[:, 0], cache

    def prefill_chunk_step(self, params: Params, tokens: torch.Tensor,
                           cache: Params, true_length: torch.Tensor,
                           adapters: Optional[dict] = None,
                           adapter_ids: Optional[torch.Tensor] = None
                           ) -> tuple[torch.Tensor, Params]:
        """One chunk of a prompt appended to a running single-request
        cache through ``verify_step``: returns (the last real token's
        logits (B, V) f32, cache with ``index`` advanced by
        ``true_length``)."""
        b = tokens.shape[0]
        logits, cache = self.verify_step(params, tokens, cache,
                                         adapters=adapters,
                                         adapter_ids=adapter_ids)
        tl = true_length.to(torch.int32)
        cache["index"] += tl
        return logits[torch.arange(b, device=logits.device),
                      tl.long() - 1], cache

    def decode_step(self, params: Params, token: torch.Tensor,
                    cache: Params, active: Optional[torch.Tensor] = None,
                    adapters: Optional[dict] = None,
                    adapter_ids: Optional[torch.Tensor] = None,
                    check: bool = True) -> tuple[torch.Tensor, Params]:
        """One token per row of a contiguous cache (the JAX
        ``decode_step``): token (B,) -> (logits (B, V) f32, cache), the
        K = 1 ``verify_step`` and then ``index`` advanced in place where
        ``active``. Inactive rows keep their cache and index. ``check``
        False skips the host-side bounds check, so that the step makes no
        host sync and can be captured (the engine keeps every row inside
        its budget)."""
        b = token.shape[0]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=token.device)
        logits, cache = self.verify_step(params, token[:, None], cache,
                                         active, adapters, adapter_ids,
                                         check=check)
        cache["index"] += active.to(torch.int32)
        return logits[:, 0], cache

    # every per-position section of a contiguous cache, (L, B, ...) each
    _SLOT_SECTIONS = ("k", "v", "k_l", "v_l", "k_g", "v_g", "k_scale",
                      "v_scale", "k_l_scale", "v_l_scale", "k_g_scale",
                      "v_g_scale", "c", "kr", "c_scale", "kr_scale",
                      "c_pre", "kr_pre", "c_pre_scale", "kr_pre_scale")

    @staticmethod
    def insert_into_slot(cache: Params, single: Params, slot: int) -> Params:
        """A prefilled single-request cache (batch 1) copied into row
        ``slot`` of a batch cache of the same layout, IN PLACE (the JAX
        ``insert_into_slot`` returns a new cache): every section present,
        ``index`` and ``abs_pos``. ``single`` is only read."""
        cache["index"][slot] = single["index"][0]
        for name in LlamaModel._SLOT_SECTIONS:
            if name in cache:
                cache[name][:, slot].copy_(single[name][:, 0])
        if "abs_pos" in cache:
            cache["abs_pos"][slot].copy_(single["abs_pos"][0])
        return cache

    def verify_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params, active: Optional[torch.Tensor] = None,
                    adapters: Optional[dict] = None,
                    adapter_ids: Optional[torch.Tensor] = None,
                    check: bool = True) -> tuple[torch.Tensor, Params]:
        """K tokens per row of a contiguous cache in one pass (the JAX
        model's dense ``verify_step``): row b's token j sits at position
        index[b] + j and attends positions <= index[b] + j within its
        layer's window. Writes every active row's K/V in place (a linear
        section at the position, a ring at slot position % R, after
        ``abs_pos`` takes this call's positions, once, before any layer),
        does not advance ``index``, returns (logits (B, K, V) f32, cache).
        Every write is ``where(active, new, old)`` at fixed shapes, so the
        step makes no host sync; a linear write past the section is
        dropped, as the JAX scatter drops it. ``check`` (the eager
        default) raises when an active position lies past a linear
        section. Attention is plain f32 einsum over the whole cache, as in
        the reference: a ring layer masks on ``abs_pos``, a linear one on
        the position, the score soft cap before the mask. Over a
        head-sharded cache (``cache_shards``) each shard's rows are written
        into its own heads and its q-head block attends them alone, the
        shards' heads then side by side, as ``_paged_attend`` runs a
        sharded arena. An MLA model
        runs ``_verify_step_mla``. ``adapters``/``adapter_ids`` add each
        row's multi-LoRA deltas."""
        cfg = self.cfg
        b, kk = tokens.shape
        dev = tokens.device
        ids = self._check_adapters(adapters, adapter_ids)
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=dev)
        positions = (cache["index"].long()[:, None]
                     + torch.arange(kk, device=dev)[None, :])      # (B,K)
        linear = cache.get("k_g", cache.get(self._cache_sections()[0]))
        max_len = (linear.shape[2]
                   if "k_g" in cache or "abs_pos" not in cache else None)
        if (check and max_len is not None and active.any()
                and int(positions[active].max()) >= max_len):
            raise ValueError(f"verify positions run past the cache length "
                             f"{max_len}")
        rows = torch.arange(b, device=dev)[:, None].expand(b, kk)
        act = active[:, None].expand(b, kk)
        # per kind of layer (ring or not): where it writes (slots (B, K)
        # and a write mask (B, K)) and the position each of its slots
        # holds, (B or 1, 1, L)
        writes, held = {}, {}
        if max_len is not None:
            # a dropped write (past the section) rewrites its old value K
            # slots back, below the row's index, where no write of this
            # call lands
            inside = positions < max_len
            writes[False] = (torch.where(
                inside, positions,
                (positions - kk).clamp(0, max_len - 1)), act & inside)
            held[False] = torch.arange(max_len, device=dev)[None, None, :]
        if "abs_pos" in cache:
            abs_pos = cache["abs_pos"]
            slots_r = positions % abs_pos.shape[1]
            abs_pos[rows, slots_r] = torch.where(
                act, positions.to(torch.int32), abs_pos[rows, slots_r])
            writes[True] = (slots_r, act)
            held[True] = abs_pos[:, None, :].long()
        masks = {}

        def mask(ring: bool, window: Optional[int]) -> torch.Tensor:
            """(B, K, L): query j of row b sees the positions <= its own
            within ``window``."""
            if (ring, window) not in masks:
                p, q = held[ring], positions[:, :, None]
                valid = (p >= 0) & (p <= q)
                if window is not None:
                    valid &= q - p < window
                masks[ring, window] = valid
            return masks[ring, window]

        # rows past the RoPE table (inactive rows only) look up its end
        rope_pos = positions.clamp(max=cfg.max_seq_len - 1)
        if cfg.is_mla:
            return self._verify_step_mla(params, tokens, cache, rope_pos,
                                         mask(False, None)[:, None], rows,
                                         *writes[False])
        hd, dt, hkv = cfg.head_dim_, cfg.dtype, cfg.n_kv_heads
        group = cfg.n_heads // hkv
        cap = cfg.attn_logit_softcap
        # a head-sharded cache: each shard's q-head block attends its own
        # kv heads (the shard axis n of the einsums; n = 1 whole)
        ns = self.cache_shards(cache)
        x = self._embed(params, tokens)
        lp = params["layers"]
        for layer in range(cfg.n_layers):
            ad = _layer_adapters(adapters, layer)

            def leaf(n):
                return _at(lp[n], layer)

            h = rms_norm(x, self._norm_w(leaf("attn_norm")), cfg.norm_eps)
            q, k, v = self._qkv(h, leaf, ad, ids, rope_pos, self.rope(layer))
            (kc, vc), (ks, vs), ring = self._layer_cache(cache, layer)
            slots, write = writes[ring]
            if ks is not None:
                k, k_s = _kv_quant(k)
                v, v_s = _kv_quant(v)
                _write_shards(ks, rows, slots, _shard_heads(k_s, ns), write,
                              ns)
                _write_shards(vs, rows, slots, _shard_heads(v_s, ns), write,
                              ns)
            _write_shards(kc, rows, slots, _shard_heads(k, ns), write, ns)
            _write_shards(vc, rows, slots, _shard_heads(v, ns), write, ns)
            k_read = _kv_dequant(kc, ks) if ks is not None else kc.float()
            v_read = _kv_dequant(vc, vs) if vs is not None else vc.float()
            if ns == 1:
                k_read, v_read = k_read[None], v_read[None]
            qg = (q.float() * cfg.sm_scale).reshape(b, kk, ns, hkv // ns,
                                                    group, hd)
            sc = torch.einsum("bqnhgd,nbLhd->bnhgqL", qg, k_read)
            if cap is not None:
                sc = torch.tanh(sc / cap) * cap
            valid = mask(ring, self.window(layer))[:, None, None, None]
            sc = sc.masked_fill(~valid, -1e30)
            p = torch.softmax(sc, dim=-1)
            o = torch.einsum("bnhgqL,nbLhd->bqnhgd", p, v_read)
            o = o.reshape(b, kk, cfg.n_heads * hd).to(dt)
            o = self._post_norm(self._proj(o, leaf("wo"), "wo", ad, ids),
                                leaf, "attn_post_norm")
            x = self._paged_mlp(x + o, lp, layer, ad, ids)
        return self._head_logits(params, x), cache

    def _verify_step_mla(self, params: Params, tokens: torch.Tensor,
                         cache: Params, rope_pos: torch.Tensor,
                         valid: torch.Tensor, rows: torch.Tensor,
                         slots: torch.Tensor, write: torch.Tensor
                         ) -> tuple[torch.Tensor, Params]:
        """``verify_step`` of an MLA model (the JAX ``_verify_step_mla``),
        in the absorbed form on the contiguous latent cache: each row's
        latent and rope key (int8 with their ``_kv_quant`` scales in an
        int8 cache) written at its (row, slot) pair where ``write``, the
        query folded through w_uk and the softmax-weighted latent through
        w_uv, in plain f32 (the JAX package has no kernel here); ``valid``
        (B, 1, K, L) keeps each query to positions <= its own."""
        cfg = self.cfg
        b, kk = tokens.shape
        hd, r, hn, dt = (cfg.head_dim_, cfg.mla_latent_dim, cfg.n_heads,
                         cfg.dtype)
        scale = cfg.sm_scale
        quant = "c_scale" in cache
        x = self._embed(params, tokens)
        for lp, layer, sfx in self._stack_layers(params):
            h = rms_norm(x, self._norm_w(lp["attn_norm"][layer]),
                         cfg.norm_eps)
            q_nope, q_rope, c, kr = self._mla_project(h, lp, layer,
                                                      rope_pos)
            cc, krc = cache["c" + sfx][layer], cache["kr" + sfx][layer]
            cs = krs = None
            if quant:
                cs = cache["c" + sfx + "_scale"][layer]
                krs = cache["kr" + sfx + "_scale"][layer]
                c, c_s = _kv_quant(c)                       # (B,K,r), (B,K)
                kr, kr_s = _kv_quant(kr)
                _write_rows(cs, rows, slots, c_s, write)
                _write_rows(krs, rows, slots, kr_s, write)
            _write_rows(cc, rows, slots, c, write)
            _write_rows(krc, rows, slots, kr, write)
            c_read = _kv_dequant(cc, cs) if quant else cc.float()    # (B,L,r)
            kr_read = _kv_dequant(krc, krs) if quant else krc.float()
            q_lat = torch.einsum("bkhd,rhd->bkhr", q_nope.float() * scale,
                                 lp["w_uk"][layer].float().view(r, hn, hd))
            sc = (torch.einsum("bkhr,blr->bhkl", q_lat, c_read)
                  + torch.einsum("bkhd,bld->bhkl", q_rope.float() * scale,
                                 kr_read))
            sc = sc.masked_fill(~valid, -1e30)
            p = torch.softmax(sc, dim=-1)
            o_lat = torch.einsum("bhkl,blr->bkhr", p, c_read)
            o = torch.einsum("bkhr,rhd->bkhd", o_lat,
                             lp["w_uv"][layer].float().view(r, hn, hd))
            o = _mm(o.reshape(b, kk, hn * hd).to(dt), _at(lp["wo"], layer),
                    dt)
            x = x + self._post_norm(o, lambda n: lp[n][layer],
                                    "attn_post_norm")
            x = self._paged_mlp(x, lp, layer)
        return self._head_logits(params, x), cache

    def init_paged_arena(self, n_pages: int, page_tokens: int,
                         quantize: bool = False,
                         shard_kv: bool = True) -> Params:
        """{"k", "v"} of shape (L, n_pages + 1, T, Hkv, D): page-major
        (page p's T positions are one contiguous tile), plus the sink page
        at index ``n_pages`` that absorbs dropped writes. ``quantize``:
        int8 k/v with per-(position, kv head) f32 scale sections
        ``k_scale``/``v_scale`` (L, n_pages + 1, T, Hkv). Under a tensor
        mesh the kv-head axis shards when ``shard_kv`` and
        ``paged_head_shards`` allow it (the module docstring's layouts),
        else every shard reads the one replicated arena.

        An MLA config gets the headless latent layout: {"c", "kr"} of
        shape (L, n_pages + 1, T, r) and (L, n_pages + 1, T, dr), the
        normed latent and the rotated rope key every head reads, in the
        compute dtype, or with ``quantize`` int8 plus per-position f32
        scale sections ``c_scale``/``kr_scale`` (L, n_pages + 1, T). With
        a dense prefix of kpre layers (DeepSeek) the main sections hold
        L - kpre layers and the prefix pages its own ``c_pre``/``kr_pre``
        (kpre, n_pages + 1, T, ...) (and ``c_pre_scale``/``kr_pre_scale``),
        the JAX arena's section names and layout.

        A windowed interleave (pattern > 1) gets an arena too, as the
        prefix pool of a contiguous loop over a linear cache; its paged
        steps refuse it."""
        cfg = self.cfg
        dt = torch.int8 if quantize else cfg.dtype
        if cfg.is_mla:
            arena: Params = {}
            for _, n, sfx in self.stack_layout():
                lead = (n, n_pages + 1, page_tokens)
                for name, width in (("c", cfg.mla_latent_dim),
                                    ("kr", cfg.mla_rope_dim)):
                    arena[name + sfx] = torch.zeros(
                        lead + (width,), dtype=dt, device=self.device)
                    if quantize:
                        arena[name + sfx + "_scale"] = torch.zeros(
                            lead, dtype=torch.float32, device=self.device)
            return arena
        n = (paged_head_shards(self.tp, cfg.n_heads, cfg.n_kv_heads)
             if shard_kv else 1)
        lead = cfg.n_layers * (n if n > 1 and self.mesh.in_process else 1)
        shape = (lead, n_pages + 1, page_tokens, cfg.n_kv_heads // n,
                 cfg.head_dim_)
        arena = {"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device)}
        if quantize:
            for name in ("k_scale", "v_scale"):
                arena[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                          device=self.device)
        return arena

    def paged_decode_step(self, params: Params, token: torch.Tensor,
                          arena: Params, page_tables: torch.Tensor,
                          lengths: torch.Tensor,
                          active: Optional[torch.Tensor] = None,
                          adapters: Optional[dict] = None,
                          adapter_ids: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, Params, torch.Tensor]:
        """One decode token per slot: token (B,) -> (logits (B, V) f32,
        arena, lengths advanced where active). The K=1 case of
        ``paged_verify_step``."""
        b = token.shape[0]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=token.device)
        logits, arena = self.paged_verify_step(
            params, token[:, None], arena, page_tables, lengths, active,
            adapters=adapters, adapter_ids=adapter_ids)
        return logits[:, 0], arena, torch.where(active, lengths + 1, lengths)

    def paged_verify_step(self, params: Params, tokens: torch.Tensor,
                          arena: Params, page_tables: torch.Tensor,
                          lengths: torch.Tensor,
                          active: Optional[torch.Tensor] = None,
                          n_tokens: Optional[torch.Tensor] = None,
                          adapters: Optional[dict] = None,
                          adapter_ids: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, Params]:
        """K tokens per slot in one pass: tokens (B, K) -> (logits
        (B, K, V) f32, arena). Slot b's query j sits at position
        lengths[b] + j; its K/V row scatters into page
        page_tables[b, pos // T] at offset pos % T, then attention runs
        the causal in-block mask through ``paged_attention_multi``. Rows at
        or beyond ``n_tokens[b]`` (default: K for active slots, 0 for
        inactive ones) scatter nothing and give logits nobody reads.
        ``lengths`` is not advanced. ``adapters`` (the stacks) and
        ``adapter_ids`` (B,) add each slot's multi-LoRA deltas to q, k, v,
        wo and the MLP, as the contiguous ``verify_step`` does."""
        x = self._paged_layers(params, tokens, arena, page_tables, lengths,
                               active, n_tokens, adapters, adapter_ids)
        return self._head_logits(params, x), arena

    def paged_prefill_chunk_step(self, params: Params, tokens: torch.Tensor,
                                 arena: Params, page_tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 true_length: torch.Tensor,
                                 adapters: Optional[dict] = None,
                                 adapter_ids: Optional[torch.Tensor] = None
                                 ) -> tuple[torch.Tensor, Params,
                                            torch.Tensor]:
        """One chunk of a prompt scattered straight into arena pages:
        ``tokens`` (B, S) (padding allowed), ``true_length`` (B,) the real
        count, ``lengths`` (B,) tokens the run already holds. Returns
        (last real token's logits (B, V) f32, arena, lengths +
        true_length). The LM head runs on the last real row only: the
        same values as ``paged_verify_step``'s row, without a (B, S, V)
        logits tensor."""
        b = tokens.shape[0]
        tl = true_length.to(torch.int32)
        x = self._paged_layers(params, tokens, arena, page_tables, lengths,
                               None, tl, adapters, adapter_ids)
        rows = torch.arange(b, device=x.device)
        last = x[rows, tl.long() - 1][:, None]
        return (self._head_logits(params, last)[:, 0], arena,
                lengths + tl)

    # -- internals ----------------------------------------------------------

    def _head_logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self._norm_w(params["final_norm"]), self.cfg.norm_eps)
        return self._lm_head(params, x).float()

    def _check_pageable(self) -> None:
        """The JAX paged steps' refusal: a windowed interleave's split
        ring/global cache cannot page."""
        cfg = self.cfg
        if cfg.sliding_window is not None and cfg.sliding_window_pattern != 1:
            raise ValueError("paged decode covers uniform sliding windows "
                             "only (pattern 1); the windowed interleave's "
                             "split ring/global cache cannot page")

    def _paged_layers(self, params, tokens, arena, page_tables, lengths,
                      active, n_tokens, adapters=None,
                      adapter_ids=None) -> torch.Tensor:
        self._check_pageable()
        cfg = self.cfg
        b, kk = tokens.shape
        dev = tokens.device
        ids = self._check_adapters(adapters, adapter_ids)
        if n_tokens is None:
            if active is None:
                active = torch.ones((b,), dtype=torch.bool, device=dev)
            n_tokens = torch.where(active, kk, 0)
        n_tokens = n_tokens.to(torch.int32)
        lengths = lengths.to(torch.int32)
        page_tables = page_tables.to(torch.int32).contiguous()
        first = arena["c" if cfg.is_mla else "k"]
        t = first.shape[2]
        sink = first.shape[1] - 1
        n_cols = page_tables.shape[1]
        steps = torch.arange(kk, device=dev)
        positions = lengths.long()[:, None] + steps[None, :]        # (B,K)
        # rows past n_tokens may run past the table and the RoPE tables:
        # clamp their lookups (their writes go to the sink page, their
        # logits are never read)
        cols = (positions // t).clamp(max=n_cols - 1)
        pages_bk = torch.gather(page_tables.long(), 1, cols)
        write_ok = steps[None, :] < n_tokens[:, None]
        pages_bk = torch.where(write_ok, pages_bk, sink)
        offs = positions % t
        rope_pos = positions.clamp(max=cfg.max_seq_len - 1)
        att_len = (lengths + kk).to(torch.int32)
        x = self._embed(params, tokens)                           # (B,K,E)
        if cfg.is_mla:
            return self._paged_layers_mla(params, x, arena, page_tables,
                                          pages_bk, offs, rope_pos, att_len)
        hd = cfg.head_dim_
        quant = "k_scale" in arena
        n = self.kv_shards(arena)
        # every layer is the window's kind (pattern 1): the local table
        rope = self._rope_for(cfg.sliding_window)
        lp = params["layers"]
        for layer in range(cfg.n_layers):
            # each leaf indexed where it is used: this loop is the decode
            # step's host cost
            ad = _layer_adapters(adapters, layer)
            h = rms_norm(x, self._norm_w(lp["attn_norm"][layer]),
                         cfg.norm_eps)
            q, k, v = self._qkv(h, lambda n: _at(lp[n], layer), ad, ids,
                                rope_pos, rope)
            kp, vp = (self._arena_layer(arena[name], layer, n)
                      for name in ("k", "v"))
            ks = vs = None
            if quant:
                # the JAX model's per-row int8 scheme (_kv_quant); rows and
                # their scales scatter through the same pages, so dropped
                # rows land on the sink page in every section
                ks, vs = (self._arena_layer(arena[name], layer, n)
                          for name in ("k_scale", "v_scale"))
                k, k_s = _kv_quant(k)               # (B,K,h,d), (B,K,h)
                v, v_s = _kv_quant(v)
                self._kv_write(ks, k_s, pages_bk, offs, n)
                self._kv_write(vs, v_s, pages_bk, offs, n)
            self._kv_write(kp, k, pages_bk, offs, n)
            self._kv_write(vp, v, pages_bk, offs, n)
            o = self._paged_attend(q, kp, vp, ks, vs, page_tables, att_len,
                                   n)
            o = self._proj(o.reshape(b, kk, cfg.n_heads * hd),
                           _at(lp["wo"], layer), "wo", ad, ids)
            x = x + self._post_norm(o, lambda n: lp[n][layer],
                                    "attn_post_norm")
            x = self._paged_mlp(x, lp, layer, ad, ids)
        return x

    def kv_shards(self, arena: Params) -> int:
        """The kv-head shards of an arena from ``init_paged_arena``: N when
        its heads are sharded, 1 when it is whole (or headless, MLA)."""
        if "k" not in arena:
            return 1
        return self.cfg.n_kv_heads // arena["k"].shape[-2]

    def _arena_layer(self, section: torch.Tensor, layer: int,
                     n: int) -> torch.Tensor:
        """Layer ``layer`` of an arena section: (P + 1, T, ...), or for a
        head-sharded arena in one process the (N, P + 1, T, ...) view whose
        shard slices are each contiguous."""
        if n > 1 and self.mesh.in_process:
            return section.view(n, -1, *section.shape[1:])[:, layer]
        return section[layer]

    def _kv_write(self, dst: torch.Tensor, rows: torch.Tensor, pages_bk,
                  offs, n: int) -> None:
        """Scatter rows (B, K, Hkv, ...) of every kv head into one layer of
        an arena section at (page, offset): into each shard's own heads
        when the arena is head-sharded."""
        if n == 1:
            dst[pages_bk, offs] = rows
        elif self.mesh.in_process:
            dst[:, pages_bk, offs] = _shard_heads(rows, n)
        else:
            h = rows.shape[2] // n
            dst[pages_bk, offs] = rows[:, :, self.mesh.rank * h:
                                       (self.mesh.rank + 1) * h]

    def _paged_attend(self, q, kp, vp, ks, vs, page_tables, att_len,
                      n: int) -> torch.Tensor:
        """The paged kernel (int8 pages when ``ks`` is given) for q (B, K,
        Hq, D) over one layer. A head-sharded arena launches it per shard,
        on the shard's q-head block and its own arena, and gathers the
        shards' heads; a replicated one serves every head in one launch
        (in one process the shards' dispatches together, over a process
        group each rank's redundant whole dispatch)."""
        kw = dict(sm_scale=self.cfg.sm_scale,
                  logit_soft_cap=self.cfg.attn_logit_softcap,
                  sliding_window=self.cfg.sliding_window)

        def attend(qs, kps, vps, kss, vss):
            if kss is None:
                return paged_attention_multi(qs, kps, vps, page_tables,
                                             att_len, **kw)
            return paged_attention_multi_quant(qs, kps, vps, kss, vss,
                                               page_tables, att_len, **kw)

        if n == 1:
            return attend(q, kp, vp, ks, vs)
        hq = q.shape[2] // n

        def block(s):
            return q[:, :, s * hq:(s + 1) * hq].contiguous()

        if not self.mesh.in_process:
            return all_gather(attend(block(self.mesh.rank), kp, vp, ks, vs),
                              2, self.mesh)
        return torch.cat([attend(block(s), kp[s], vp[s],
                                 None if ks is None else ks[s],
                                 None if vs is None else vs[s])
                          for s in range(n)], dim=2)

    # the leaves of a layer's MLP block: the dense MLP's, or the sparse
    # MoE's with DeepSeek's correction bias and shared experts
    _MLP_LEAVES = ("mlp_norm", "w_gate", "w_up", "w_down", "router",
                   "router_bias", "we_gate", "we_up", "we_down", "ws_gate",
                   "ws_up", "ws_down", "mlp_post_norm")

    def _paged_mlp(self, x, lp, layer: int, ad: Optional[dict] = None,
                   ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``_mlp`` of layer ``layer`` of the stacked leaves ``lp``, at the
        serving capacity (with one layer's adapter stacks ``ad``)."""
        return self._mlp(x, {n: _at(lp[n], layer) for n in self._MLP_LEAVES
                             if n in lp}, False, ad, ids)

    def _mlp(self, x: torch.Tensor, lp: Params, train: bool,
             ad: Optional[dict] = None,
             ids: Optional[torch.Tensor] = None, with_aux: bool = False):
        """The JAX model's ``_mlp_block`` with its residual, on one layer's
        leaves: the SwiGLU (or GeGLU) MLP, or for a layer with a router
        ``moe_mlp`` (a DeepSeek model's dense prefix holds the dense MLP's
        leaves, its other layers the router's). ``train`` routes at
        ``cfg.capacity_factor``; serving (``train=False``) at n_experts /
        n_experts_per_tok, so the capacity is every token and nothing
        drops, as in the JAX model. V3's ``router_bias`` selects by sigmoid
        scores (``route_top_k_v3``); DeepSeek's shared experts, a dense
        SwiGLU of the ``ws_*`` leaves the router never sees, add to the
        routed output. ``with_aux`` returns (x, aux): aux the f32
        ``router_aux_coef`` x load-balance loss + ``router_z_coef`` x z-loss
        of a routed layer (the JAX ``_mlp_block``'s), 0 for a dense one;
        without it the router's losses are not computed (serving). ``ad``
        adds each row's multi-LoRA deltas to the dense MLP's three
        products. With ``post_norms`` the output passes ``mlp_post_norm``
        before the residual add."""
        cfg, dt = self.cfg, self.cfg.dtype
        h = rms_norm(x, self._norm_w(lp["mlp_norm"]), cfg.norm_eps)
        if "router" not in lp:
            gate = self._proj(h, lp["w_gate"], "w_gate", ad, ids)
            gate = (F.silu(gate) if cfg.mlp_activation == "silu"
                    else F.gelu(gate, approximate="tanh"))
            act = gate * self._proj(h, lp["w_up"], "w_up", ad, ids)
            y = self._proj(act, lp["w_down"], "w_down", ad, ids)
            aux = torch.zeros((), dtype=torch.float32, device=x.device) \
                if with_aux else None
        else:
            factor = (cfg.capacity_factor if train
                      else cfg.n_experts / cfg.n_experts_per_tok)
            y, lb, z = moe_mlp(h, lp["router"], lp["we_gate"], lp["we_up"],
                               lp["we_down"],
                               n_experts_per_tok=cfg.n_experts_per_tok,
                               capacity_factor=factor, dtype=dt,
                               norm_topk=cfg.router_norm_topk,
                               router_bias=lp.get("router_bias"),
                               router_n_group=cfg.router_n_group,
                               router_topk_group=cfg.router_topk_group,
                               routed_scaling=cfg.routed_scaling_factor,
                               with_losses=with_aux,
                               mesh=None if train else self.mesh)
            aux = (cfg.router_aux_coef * lb + cfg.router_z_coef * z
                   if with_aux else None)
            if "ws_gate" in lp:
                act = F.silu(_mm(h, lp["ws_gate"], dt)) * _mm(h, lp["ws_up"],
                                                               dt)
                y = y + _mm(act, lp["ws_down"], dt)
        x = x + self._post_norm(y, lp.__getitem__, "mlp_post_norm")
        return (x, aux) if with_aux else x

    def _mla_project(self, h, lp, layer: Optional[int], positions):
        """Port of the JAX ``_mla_project``: q_nope (B,K,H,hd), q_rope
        (B,K,H,dr) rotated, the latent c (B,K,r) normed by ``c_norm``, and
        the shared rope key kr (B,K,dr) rotated. q is full rank through
        ``wq``, or with ``mla_q_lora_rank`` ``w_qa`` -> ``q_a_norm`` ->
        ``w_qb``. RoPE math runs in f32 and rounds to the compute dtype,
        as in JAX. ``lp`` holds the stacked leaves and ``layer`` picks
        one, or with ``layer`` None ``lp`` is one layer's leaves."""
        cfg = self.cfg
        b, kk, _ = h.shape
        hd, dr, r, dt = (cfg.head_dim_, cfg.mla_rope_dim, cfg.mla_latent_dim,
                         cfg.dtype)

        def leaf(name: str):
            return lp[name] if layer is None else _at(lp[name], layer)

        if cfg.mla_q_lora_rank is not None:
            qa = rms_norm(_mm(h, leaf("w_qa"), dt),
                          self._norm_w(leaf("q_a_norm")), cfg.norm_eps)
            q = _mm(qa, leaf("w_qb"), dt)
        else:
            q = _mm(h, leaf("wq"), dt)
        q = q.reshape(b, kk, cfg.n_heads, hd + dr)
        ckr = _mm(h, leaf("w_dkv"), dt)
        # the RMSNorm kernel takes unit-stride rows: c is a slice of ckr
        c = rms_norm(ckr[..., :r].contiguous(), self._norm_w(leaf("c_norm")),
                     cfg.norm_eps)
        q_rope = apply_rope(q[..., hd:], self.cos, self.sin, positions)
        kr = apply_rope(ckr[..., None, r:], self.cos, self.sin,
                        positions)[:, :, 0]
        return q[..., :hd], q_rope, c, kr

    def _paged_layers_mla(self, params, x, arena, page_tables, pages_bk,
                          offs, rope_pos, att_len) -> torch.Tensor:
        """The layers of ``_paged_layers`` for an MLA model: the port of
        the JAX ``_paged_verify_step_mla``. Per layer, each row's latent
        and rope key scatter at (page, offset) (int8 with their
        ``_kv_quant`` scales in an int8 arena; dropped rows to the sink);
        the query is absorbed through ``w_uk`` in f32, the latent kernel
        attends the pages, and its weighted latent is up-projected through
        ``w_uv`` in f32, then ``wo`` and the MLP. A dense prefix's layers
        run first, over its own sections (the JAX scan over
        ``prefix_layers`` and ``c_pre``/``kr_pre``)."""
        cfg = self.cfg
        b, kk, _ = x.shape
        hd, r, hn, dt = cfg.head_dim_, cfg.mla_latent_dim, cfg.n_heads, \
            cfg.dtype
        quant = "c_scale" in arena
        for lp, layer, sfx in self._stack_layers(params):
            h = rms_norm(x, self._norm_w(lp["attn_norm"][layer]),
                         cfg.norm_eps)
            q_nope, q_rope, c, kr = self._mla_project(h, lp, layer, rope_pos)
            cp, krp = arena["c" + sfx][layer], arena["kr" + sfx][layer]
            if quant:
                cs = arena["c" + sfx + "_scale"][layer]
                krs = arena["kr" + sfx + "_scale"][layer]
                c, c_s = _kv_quant(c)                   # (B,K,r), (B,K)
                kr, kr_s = _kv_quant(kr)
                cs[pages_bk, offs] = c_s
                krs[pages_bk, offs] = kr_s
            cp[pages_bk, offs] = c
            krp[pages_bk, offs] = kr
            q_lat = torch.einsum("bkhd,rhd->bkhr", q_nope.float(),
                                 lp["w_uk"][layer].float().view(r, hn, hd))
            if quant:
                o_lat = paged_attention_multi_mla_quant(
                    q_lat, q_rope.float(), cp, krp, cs, krs, page_tables,
                    att_len, sm_scale=cfg.sm_scale)
            else:
                o_lat = paged_attention_multi_mla(
                    q_lat, q_rope.float(), cp, krp, page_tables, att_len,
                    sm_scale=cfg.sm_scale)
            o = torch.einsum("bkhr,rhd->bkhd", o_lat,
                             lp["w_uv"][layer].float().view(r, hn, hd))
            o = _mm(o.reshape(b, kk, hn * hd).to(dt), _at(lp["wo"], layer),
                    dt)
            x = x + self._post_norm(o, lambda n: lp[n][layer],
                                    "attn_post_norm")
            x = self._paged_mlp(x, lp, layer)
        return x
