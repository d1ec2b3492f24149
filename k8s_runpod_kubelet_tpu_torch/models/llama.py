"""Llama-3-family dense decoder over a paged KV arena (port of the serving
half of the JAX package's ``models/llama.py``).

Parameters are a plain dict in the JAX package's tree layout, stacked over
layers: ``tok_embed`` (V, E), ``final_norm`` (E,), ``lm_head`` (E, V) and
``layers/*`` with a leading (L, ...) axis. Matmul weights, the embedding
and the LM head are stored in the compute dtype (the JAX model keeps f32
params and casts them to ``cfg.dtype`` at every use, which gives the same
values); norm weights stay f32, because RMSNorm applies them in f32.

The arena is ``{"k", "v"}`` of shape (L, P + 1, T, Hkv, D) and is updated
IN PLACE (the JAX model donated it instead). Page P is a sink no page
table names: rows that must not be written (past ``n_tokens``, inactive
slots, whose stale table rows may alias another slot's live tail page)
scatter there, where the JAX model used page id P with ``mode="drop"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import apply_rope, paged_attention_multi, rms_norm, \
    rope_frequencies

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The dense fields of the JAX ``LlamaConfig`` this port serves, with
    the same defaults. MoE, LoRA, int8/int4, MLA, ring attention, meshes,
    sliding windows and soft caps are later slices."""
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
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16  # activation/compute/weight dtype

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.embed_dim // self.n_heads

    @property
    def sm_scale(self) -> float:
        return self.head_dim_ ** -0.5


def llama3_8b() -> LlamaConfig:
    return LlamaConfig(name="llama3-8b", vocab_size=128256, embed_dim=4096,
                       n_layers=32, n_heads=32, n_kv_heads=8, mlp_dim=14336,
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


def tiny_llama(**kw) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig(), **kw)


def _layer_shapes(cfg: LlamaConfig) -> dict:
    e, hd, n = cfg.embed_dim, cfg.head_dim_, cfg.n_layers
    return {"attn_norm": (n, e),
            "wq": (n, e, cfg.n_heads * hd),
            "wk": (n, e, cfg.n_kv_heads * hd),
            "wv": (n, e, cfg.n_kv_heads * hd),
            "wo": (n, cfg.n_heads * hd, e),
            "mlp_norm": (n, e),
            "w_gate": (n, e, cfg.mlp_dim),
            "w_up": (n, e, cfg.mlp_dim),
            "w_down": (n, cfg.mlp_dim, e)}


def param_shapes(cfg: LlamaConfig) -> Params:
    shapes: Params = {"tok_embed": (cfg.vocab_size, cfg.embed_dim),
                      "final_norm": (cfg.embed_dim,),
                      "layers": _layer_shapes(cfg)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.embed_dim, cfg.vocab_size)
    return shapes


def is_norm(name: str) -> bool:
    return name.endswith("norm")


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random init from ``generator`` (normal * 0.02, norms at 1), built
    directly on ``device`` (default ``cuda``) one layer at a time, so the
    f32 draw never holds more than one layer's leaf. ``generator`` must
    live on that device."""
    dev = resolve_device(device)

    def draw(shape) -> torch.Tensor:
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        rows = out.reshape(shape[0], -1) if len(shape) > 2 else out[None]
        for r in rows:
            r.copy_(torch.randn(r.shape, generator=generator, device=dev,
                                dtype=torch.float32) * 0.02)
        return out

    def make(name: str, shape) -> torch.Tensor:
        if is_norm(name):
            return torch.ones(shape, dtype=torch.float32, device=dev)
        return draw(shape)

    shapes = param_shapes(cfg)
    params: Params = {name: make(name, s) for name, s in shapes.items()
                      if name != "layers"}
    params["layers"] = {name: make(name, s)
                        for name, s in shapes["layers"].items()}
    return params


class LlamaModel:
    """Paged serving steps over a per-model arena. ``device`` defaults to
    ``cuda`` and raises without a card."""

    def __init__(self, cfg: LlamaConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cos, self.sin = rope_frequencies(
            cfg.head_dim_, cfg.max_seq_len, cfg.rope_theta, cfg.rope_scaling,
            device=self.device)

    def init_paged_arena(self, n_pages: int, page_tokens: int) -> Params:
        """{"k", "v"} of shape (L, n_pages + 1, T, Hkv, D): page-major
        (page p's T positions are one contiguous tile), plus the sink page
        at index ``n_pages`` that absorbs dropped writes."""
        cfg = self.cfg
        shape = (cfg.n_layers, n_pages + 1, page_tokens, cfg.n_kv_heads,
                 cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device)}

    def paged_decode_step(self, params: Params, token: torch.Tensor,
                          arena: Params, page_tables: torch.Tensor,
                          lengths: torch.Tensor,
                          active: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, Params, torch.Tensor]:
        """One decode token per slot: token (B,) -> (logits (B, V) f32,
        arena, lengths advanced where active). The K=1 case of
        ``paged_verify_step``."""
        b = token.shape[0]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=token.device)
        logits, arena = self.paged_verify_step(
            params, token[:, None], arena, page_tables, lengths, active)
        return logits[:, 0], arena, torch.where(active, lengths + 1, lengths)

    def paged_verify_step(self, params: Params, tokens: torch.Tensor,
                          arena: Params, page_tables: torch.Tensor,
                          lengths: torch.Tensor,
                          active: Optional[torch.Tensor] = None,
                          n_tokens: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, Params]:
        """K tokens per slot in one pass: tokens (B, K) -> (logits
        (B, K, V) f32, arena). Slot b's query j sits at position
        lengths[b] + j; its K/V row scatters into page
        page_tables[b, pos // T] at offset pos % T, then attention runs
        the causal in-block mask through ``paged_attention_multi``. Rows at
        or beyond ``n_tokens[b]`` (default: K for active slots, 0 for
        inactive ones) scatter nothing and give logits nobody reads.
        ``lengths`` is not advanced."""
        x = self._paged_layers(params, tokens, arena, page_tables, lengths,
                               active, n_tokens)
        return self._head_logits(params, x), arena

    def paged_prefill_chunk_step(self, params: Params, tokens: torch.Tensor,
                                 arena: Params, page_tables: torch.Tensor,
                                 lengths: torch.Tensor,
                                 true_length: torch.Tensor
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
                               None, tl)
        rows = torch.arange(b, device=x.device)
        last = x[rows, tl.long() - 1][:, None]
        return (self._head_logits(params, last)[:, 0], arena,
                lengths + tl)

    # -- internals ----------------------------------------------------------

    def _head_logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = (params["tok_embed"].t() if cfg.tie_embeddings
                else params["lm_head"])
        return (x @ head).float()

    def _paged_layers(self, params, tokens, arena, page_tables, lengths,
                      active, n_tokens) -> torch.Tensor:
        cfg = self.cfg
        b, kk = tokens.shape
        dev = tokens.device
        if n_tokens is None:
            if active is None:
                active = torch.ones((b,), dtype=torch.bool, device=dev)
            n_tokens = torch.where(active, kk, 0)
        n_tokens = n_tokens.to(torch.int32)
        lengths = lengths.to(torch.int32)
        page_tables = page_tables.to(torch.int32).contiguous()
        t = arena["k"].shape[2]
        sink = arena["k"].shape[1] - 1
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
        hd = cfg.head_dim_
        x = params["tok_embed"][tokens.long()]                    # (B,K,E)
        lp = params["layers"]
        for layer in range(cfg.n_layers):
            h = rms_norm(x, lp["attn_norm"][layer], cfg.norm_eps)
            q = (h @ lp["wq"][layer]).reshape(b, kk, cfg.n_heads, hd)
            k = (h @ lp["wk"][layer]).reshape(b, kk, cfg.n_kv_heads, hd)
            v = (h @ lp["wv"][layer]).reshape(b, kk, cfg.n_kv_heads, hd)
            q = apply_rope(q, self.cos, self.sin, rope_pos)
            k = apply_rope(k, self.cos, self.sin, rope_pos)
            kp, vp = arena["k"][layer], arena["v"][layer]
            kp[pages_bk, offs] = k
            vp[pages_bk, offs] = v
            o = paged_attention_multi(q, kp, vp, page_tables, att_len,
                                      sm_scale=cfg.sm_scale)
            x = x + o.reshape(b, kk, cfg.n_heads * hd) @ lp["wo"][layer]
            h = rms_norm(x, lp["mlp_norm"][layer], cfg.norm_eps)
            act = F.silu(h @ lp["w_gate"][layer]) * (h @ lp["w_up"][layer])
            x = x + act @ lp["w_down"][layer]
        return x
