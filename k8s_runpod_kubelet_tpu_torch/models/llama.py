"""Llama-3-family decoder (port of the JAX package's ``models/llama.py``):
the contiguous ``forward`` that training runs, and the paged serving
steps over a KV arena, for dense attention and for Multi-head Latent
Attention (MLA, DeepSeek-V2), which serves from a latent arena.

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

The arena is ``{"k", "v"}`` of shape (L, P + 1, T, Hkv, D) and is updated
IN PLACE (the JAX model donated it instead); an int8 arena adds
``k_scale``/``v_scale`` (L, P + 1, T, Hkv) f32. An MLA model's arena is
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
                   paged_attention_multi, paged_attention_multi_mla,
                   paged_attention_multi_mla_quant,
                   paged_attention_multi_quant, rms_norm, rope_frequencies)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The fields of the JAX ``LlamaConfig`` this port runs, with the same
    defaults (weight and KV quantization are serving options,
    ``ServingConfig``). MoE and DeepSeek's dense prefix, LoRA, ring
    attention, meshes, sliding windows, soft caps and remat "dots" are
    later slices."""
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
    param_dtype: torch.dtype = torch.float32  # training's master weights
    remat: bool = True
    # "full": recompute each layer in backward (one more forward of
    # flops, least memory); "none": keep every activation
    remat_policy: str = "full"
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

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.embed_dim // self.n_heads

    @property
    def is_mla(self) -> bool:
        return self.mla_latent_dim is not None

    @property
    def sm_scale(self) -> float:
        """The softmax scale: head_dim^-0.5, or for MLA (head_dim +
        rope_dim)^-0.5 times YaRN's mscale^2."""
        if self.is_mla:
            return ((self.head_dim_ + self.mla_rope_dim) ** -0.5
                    * yarn_mscale_sq(self))
        return self.head_dim_ ** -0.5

    def validate_mla(self) -> None:
        """The JAX config's MLA check that applies to the fields this port
        has (the fields MLA excludes, windows, soft caps, qk norms and
        biases, are not in it): q_lora_rank needs MLA."""
        if self.mla_q_lora_rank is not None and not self.is_mla:
            raise ValueError("mla_q_lora_rank requires MLA (set "
                             "mla_latent_dim); on a plain-attention config "
                             "the field would silently do nothing")


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
    return {"attn_norm": (n, e),
            **attn,
            "wo": (n, hn * hd, e),
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


def _mm(h: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """h @ w for a raw weight, an int8 ``{"q8", "scale"}`` leaf (the
    dequant multiply after the matmul) or an int4 ``{"q4", "scale"}`` leaf
    (the ``int4_matmul`` kernel)."""
    if isinstance(w, dict):
        if "q4" in w:
            return int4_matmul(h.to(dtype), w["q4"], w["scale"])
        return (h @ w["q8"].to(dtype)) * w["scale"].to(dtype)
    return h @ w if w.dtype == dtype else h @ w.to(dtype)


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


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, master: bool = False) -> Params:
    """Random init from ``generator`` (normal * 0.02, norms at 1), built
    directly on ``device`` (default ``cuda``) one layer at a time, so the
    f32 draw never holds more than one layer's leaf. ``generator`` must
    live on that device. Weights are in ``cfg.dtype`` (serving), or in
    ``cfg.param_dtype`` with ``master=True`` (training); the same generator
    draws the same values, so the serving weights are the master weights
    rounded."""
    cfg.validate_mla()
    dev = resolve_device(device)
    dtype = cfg.param_dtype if master else cfg.dtype

    def draw(shape) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device=dev)
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
    """The contiguous forward (training) and the paged serving steps over a
    per-model arena. ``device`` defaults to ``cuda`` and raises without a
    card."""

    def __init__(self, cfg: LlamaConfig, device=None):
        cfg.validate_mla()
        self.cfg = cfg
        self.device = resolve_device(device)
        # MLA rotates only the decoupled rope part of q and its shared key
        rope_dim = cfg.mla_rope_dim if cfg.is_mla else cfg.head_dim_
        self.cos, self.sin = rope_frequencies(
            rope_dim, cfg.max_seq_len, cfg.rope_theta, cfg.rope_scaling,
            device=self.device)

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                return_hidden: bool = False) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) in ``cfg.dtype``, or with
        ``return_hidden`` the final-norm hidden states (B, S, E). Every
        layer is causal flash attention and a SwiGLU MLP, each behind an
        RMSNorm; weights are cast to ``cfg.dtype`` at each use. Under remat
        "full" each layer is a ``torch.utils.checkpoint`` (the counterpart
        of ``jax.checkpoint`` over the JAX model's scan body), so backward
        runs its forward once more. ``positions`` (B, S) overrides arange
        for RoPE. MLA configs raise: their contiguous (direct) form needs
        the flash kernels at head_dim + rope_dim, a later slice."""
        cfg = self.cfg
        if cfg.is_mla:
            raise ValueError(f"{cfg.name}: the contiguous forward of an MLA "
                             "model is not ported (MLA serves through the "
                             "paged steps only)")
        if cfg.remat and cfg.remat_policy not in ("full", "none"):
            raise ValueError(f"remat_policy {cfg.remat_policy!r} is not "
                             "ported (full or none)")
        x = params["tok_embed"][tokens.long()].to(cfg.dtype)
        # one unbind per stacked leaf: its backward stacks the L layer
        # gradients once
        layers = {name: leaf.unbind(0)
                  for name, leaf in params["layers"].items()}
        remat = cfg.remat and cfg.remat_policy == "full"
        for i in range(cfg.n_layers):
            lp = {name: leaves[i] for name, leaves in layers.items()}
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    self._layer, x, lp, positions, use_reentrant=False)
            else:
                x = self._layer(x, lp, positions)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if return_hidden:
            return x
        head = (params["tok_embed"].t() if cfg.tie_embeddings
                else params["lm_head"])
        return x @ head.to(cfg.dtype)

    def _layer(self, x: torch.Tensor, lp: Params,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
        """One decoder layer of ``forward``: the JAX model's dense
        ``_attention_block`` then ``_mlp_block``."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd, dt = cfg.head_dim_, cfg.dtype
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ lp["wq"].to(dt)).reshape(b, s, cfg.n_heads, hd)
        k = (h @ lp["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
        v = (h @ lp["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
        q = apply_rope(q, self.cos, self.sin, positions)
        k = apply_rope(k, self.cos, self.sin, positions)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        o = flash_attention(qt, kt, vt, causal=True, sm_scale=cfg.sm_scale)
        o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
        x = x + o @ lp["wo"].to(dt)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        act = F.silu(h @ lp["w_gate"].to(dt)) * (h @ lp["w_up"].to(dt))
        return x + act @ lp["w_down"].to(dt)

    def init_paged_arena(self, n_pages: int, page_tokens: int,
                         quantize: bool = False) -> Params:
        """{"k", "v"} of shape (L, n_pages + 1, T, Hkv, D): page-major
        (page p's T positions are one contiguous tile), plus the sink page
        at index ``n_pages`` that absorbs dropped writes. ``quantize``:
        int8 k/v with per-(position, kv head) f32 scale sections
        ``k_scale``/``v_scale`` (L, n_pages + 1, T, Hkv).

        An MLA config gets the headless latent layout: {"c", "kr"} of
        shape (L, n_pages + 1, T, r) and (L, n_pages + 1, T, dr), the
        normed latent and the rotated rope key every head reads, in the
        compute dtype, or with ``quantize`` int8 plus per-position f32
        scale sections ``c_scale``/``kr_scale`` (L, n_pages + 1, T)."""
        cfg = self.cfg
        dt = torch.int8 if quantize else cfg.dtype
        if cfg.is_mla:
            lead = (cfg.n_layers, n_pages + 1, page_tokens)
            arena = {"c": torch.zeros(lead + (cfg.mla_latent_dim,), dtype=dt,
                                      device=self.device),
                     "kr": torch.zeros(lead + (cfg.mla_rope_dim,), dtype=dt,
                                       device=self.device)}
            if quantize:
                for name in ("c_scale", "kr_scale"):
                    arena[name] = torch.zeros(lead, dtype=torch.float32,
                                              device=self.device)
            return arena
        shape = (cfg.n_layers, n_pages + 1, page_tokens, cfg.n_kv_heads,
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
        if cfg.tie_embeddings:
            return (x @ params["tok_embed"].t()).float()
        return _mm(x, params["lm_head"], cfg.dtype).float()

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
        x = params["tok_embed"][tokens.long()].to(cfg.dtype)      # (B,K,E)
        if cfg.is_mla:
            return self._paged_layers_mla(params, x, arena, page_tables,
                                          pages_bk, offs, rope_pos, att_len)
        hd, dt = cfg.head_dim_, cfg.dtype
        quant = "k_scale" in arena
        lp = params["layers"]
        for layer in range(cfg.n_layers):
            # each leaf indexed where it is used: this loop is the decode
            # step's host cost
            h = rms_norm(x, lp["attn_norm"][layer], cfg.norm_eps)
            q = _mm(h, _at(lp["wq"], layer), dt).reshape(b, kk, cfg.n_heads,
                                                         hd)
            k = _mm(h, _at(lp["wk"], layer), dt).reshape(b, kk,
                                                         cfg.n_kv_heads, hd)
            v = _mm(h, _at(lp["wv"], layer), dt).reshape(b, kk,
                                                         cfg.n_kv_heads, hd)
            q = apply_rope(q, self.cos, self.sin, rope_pos)
            k = apply_rope(k, self.cos, self.sin, rope_pos)
            kp, vp = arena["k"][layer], arena["v"][layer]
            if quant:
                # the JAX model's per-row int8 scheme (_kv_quant); rows and
                # their scales scatter through the same pages, so dropped
                # rows land on the sink page in every section
                ks, vs = arena["k_scale"][layer], arena["v_scale"][layer]
                k_w, k_s = _kv_quant(k)             # (B,K,h,d), (B,K,h)
                v_w, v_s = _kv_quant(v)
                kp[pages_bk, offs] = k_w
                ks[pages_bk, offs] = k_s
                vp[pages_bk, offs] = v_w
                vs[pages_bk, offs] = v_s
                o = paged_attention_multi_quant(
                    q, kp, vp, ks, vs, page_tables, att_len,
                    sm_scale=cfg.sm_scale)
            else:
                kp[pages_bk, offs] = k
                vp[pages_bk, offs] = v
                o = paged_attention_multi(q, kp, vp, page_tables, att_len,
                                          sm_scale=cfg.sm_scale)
            x = x + _mm(o.reshape(b, kk, cfg.n_heads * hd),
                        _at(lp["wo"], layer), dt)
            x = self._paged_mlp(x, lp, layer)
        return x

    def _paged_mlp(self, x, lp, layer: int) -> torch.Tensor:
        """The SwiGLU MLP of one layer of the paged steps, with its
        residual."""
        cfg, dt = self.cfg, self.cfg.dtype
        h = rms_norm(x, lp["mlp_norm"][layer], cfg.norm_eps)
        act = (F.silu(_mm(h, _at(lp["w_gate"], layer), dt))
               * _mm(h, _at(lp["w_up"], layer), dt))
        return x + _mm(act, _at(lp["w_down"], layer), dt)

    def _mla_project(self, h, lp, layer: int, positions):
        """Port of the JAX ``_mla_project``: q_nope (B,K,H,hd), q_rope
        (B,K,H,dr) rotated, the latent c (B,K,r) normed by ``c_norm``, and
        the shared rope key kr (B,K,dr) rotated. q is full rank through
        ``wq``, or with ``mla_q_lora_rank`` ``w_qa`` -> ``q_a_norm`` ->
        ``w_qb``. RoPE math runs in f32 and rounds to the compute dtype,
        as in JAX."""
        cfg = self.cfg
        b, kk, _ = h.shape
        hd, dr, r, dt = (cfg.head_dim_, cfg.mla_rope_dim, cfg.mla_latent_dim,
                         cfg.dtype)
        if cfg.mla_q_lora_rank is not None:
            qa = rms_norm(_mm(h, _at(lp["w_qa"], layer), dt),
                          lp["q_a_norm"][layer], cfg.norm_eps)
            q = _mm(qa, _at(lp["w_qb"], layer), dt)
        else:
            q = _mm(h, _at(lp["wq"], layer), dt)
        q = q.reshape(b, kk, cfg.n_heads, hd + dr)
        ckr = _mm(h, _at(lp["w_dkv"], layer), dt)
        # the RMSNorm kernel takes unit-stride rows: c is a slice of ckr
        c = rms_norm(ckr[..., :r].contiguous(), lp["c_norm"][layer],
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
        ``w_uv`` in f32, then ``wo`` and the MLP."""
        cfg = self.cfg
        b, kk, _ = x.shape
        hd, r, hn, dt = cfg.head_dim_, cfg.mla_latent_dim, cfg.n_heads, \
            cfg.dtype
        quant = "c_scale" in arena
        lp = params["layers"]
        for layer in range(cfg.n_layers):
            h = rms_norm(x, lp["attn_norm"][layer], cfg.norm_eps)
            q_nope, q_rope, c, kr = self._mla_project(h, lp, layer, rope_pos)
            cp, krp = arena["c"][layer], arena["kr"][layer]
            if quant:
                cs, krs = arena["c_scale"][layer], arena["kr_scale"][layer]
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
            x = x + _mm(o.reshape(b, kk, hn * hd).to(dt),
                        _at(lp["wo"], layer), dt)
            x = self._paged_mlp(x, lp, layer)
        return x
