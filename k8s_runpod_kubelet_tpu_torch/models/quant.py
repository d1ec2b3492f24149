"""Weight-only int8 and int4 quantization for serving (port of the JAX
package's ``models/quant.py``).

A quantized weight is a dict leaf: ``{"q8": int8 (..., in, out), "scale":
f32 (..., 1, out)}`` (per output channel, absmax / 127) or ``{"q4": uint8
(..., in/2, out), "scale": f32 (..., g, 1, out)}`` (groups of
``INT4_GROUP`` contraction elements, absmax / 7; in-element 2i in the low
nibble, 2i+1 in the high, each stored offset by 8). ``llama._mm`` takes
either form. The embedding is stored in the compute dtype, norms and the
MoE router and V3's router bias stay f32, q/k/v biases stay in the compute dtype, the LM head
is quantized (a tied head is the embedding's transpose, in the compute
dtype, as in the JAX package). Expert leaves (``we_gate``,
``we_up``, ``we_down``, (L, X, in, out)) quantize at both widths one
(layer, expert) slice at a time: q8 (L, X, in, out) with scale (L, X, 1,
out), or q4 (L, X, in/2, out) with scale (L, X, g, 1, out). DeepSeek's
shared experts (``ws_*``) quantize as the dense MLP does, and a dense
prefix's stack (``prefix_layers``) as the main one.

``init_quantized_params`` draws a model's random weights and quantizes
each layer's slice as soon as it is drawn, so a model too large for the
card in bf16 (Mixtral-8x7B, 93 GB) is never whole in bf16; it gives
exactly ``quantize_params(cfg, init_params(cfg, generator), bits)``.

The JAX package quantizes on the host in numpy. This port quantizes in
torch on the parameters' device, one layer slice at a time, so an 8B
model never needs an f32 copy of more than one slice; the arithmetic is
the same (f32 absmax, the 1e-8 floor, an f32 divide, round half to even,
clip, pack), and on the CPU the result is bit-identical to the JAX
quantizer's.
"""

from __future__ import annotations

import itertools
from typing import Any

import torch

from ..device import resolve_device
from .llama import (STACKS, LlamaConfig, Params, draw_rows, init_fill,
                    keeps_f32, leaf_shapes, param_shapes)

__all__ = ["INT4_GROUP", "dequantize", "init_quantized_params",
           "is_quantized", "quantize_params", "quantized_logical_axes"]

# stacked-layer projection weights, plus the LM head. MLA: w_dkv and the
# low-rank q pair quantize as the JAX quantizer's do, and so do
# DeepSeek's shared experts; w_uk/w_uv stay in full precision (the
# absorbed step folds them in f32, not through _mm)
_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "w_dkv", "ws_gate", "ws_up", "ws_down", "w_qa", "w_qb")
# sparse-MoE expert weights, (L, X, in, out): the int4 leaves go through
# int4_expert_matmul, the int8 ones through a batched product
_EXPERT_WEIGHTS = ("we_gate", "we_up", "we_down")
_QUANTIZED = frozenset(_LAYER_WEIGHTS + _EXPERT_WEIGHTS + ("lm_head",))

INT4_GROUP = 128  # contraction-axis group size of the int4 scales


def _quantize_leaf(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 of one (in, out) slice."""
    w = w.float()
    scale = w.abs().amax(dim=-2, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q8": q8, "scale": scale}


def _quantize_leaf_int4(w: torch.Tensor,
                        group_size: int = INT4_GROUP) -> dict[str, torch.Tensor]:
    """Symmetric int4 in [-7, 7] (stored + 8 in a nibble) with group-wise
    absmax scales along the contraction axis of one (in, out) slice; a
    contraction that ``group_size`` does not divide is one group."""
    w = w.float()
    kin, out = w.shape[-2], w.shape[-1]
    if kin % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, "
                         f"got {kin}")
    gs = group_size if kin % group_size == 0 else kin
    g = kin // gs
    wr = w.reshape(g, gs, out)
    scale = wr.abs().amax(dim=-2, keepdim=True) / 7.0      # (g, 1, out)
    scale = torch.clamp_min(scale, 1e-8)
    q = (torch.clamp(torch.round(wr / scale), -7, 7) + 8).to(torch.uint8)
    q = q.reshape(kin, out)
    packed = q[0::2] | (q[1::2] << 4)
    return {"q4": packed, "scale": scale}


def _quantize_into(out: dict, lead: tuple, at: tuple, w: torch.Tensor,
                   quant) -> None:
    """Quantize ``w`` (..., in, out) one (in, out) slice at a time into the
    quantized leaf ``out`` of lead shape ``lead``, at index ``at``; its
    tensors are allocated at the first slice."""
    for idx in itertools.product(*map(range, w.shape[:-2])):
        for k, v in quant(w[idx]).items():
            if k not in out:
                out[k] = torch.empty(lead + v.shape, dtype=v.dtype,
                                     device=v.device)
            out[k][at + idx] = v


def _quantize_stacked(w: torch.Tensor, quant) -> dict[str, torch.Tensor]:
    """Quantize a (..., in, out) leaf one (in, out) slice at a time (a
    layer's, or a layer's expert's) into preallocated outputs."""
    out: dict = {}
    _quantize_into(out, tuple(w.shape[:-2]), (), w, quant)
    return out


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and ("q8" in w or "q4" in w)


def quantized_logical_axes(cfg: LlamaConfig, bits: int = 8) -> Params:
    """The logical-axis tree of a quantized tree (the JAX
    ``quantized_logical_axes``), which ``parallel.shard_params`` places.
    ``bits=8``: ``q8`` keeps the base weight's axes, ``scale`` (..., 1,
    out) keeps its out axis. ``bits=4``: every packed weight shards its
    out axis (``int4_out``) with the packed contraction and the groups
    replicated, so each shard's product is an out-slice over the full
    contraction (``int4_matmul_sharded``), with no sum across shards;
    expert leaves shard their expert axis only."""
    from ..parallel.sharding import param_logical_axes

    _quantizer(bits)
    base = param_logical_axes(cfg)

    def q_axes(axes):
        lead = axes[:-2]
        if bits == 8:
            return {"q8": axes, "scale": lead + (None, axes[-1])}
        if "expert" in lead:
            return {"q4": lead + (None, None),
                    "scale": lead + (None, None, None)}
        return {"q4": lead + (None, "int4_out"),
                "scale": lead + (None, None, "int4_out")}

    out: Params = {"tok_embed": base["tok_embed"],
                   "final_norm": base["final_norm"]}
    for stack in STACKS:
        if stack in base:
            out[stack] = {name: q_axes(axes) if name in _QUANTIZED
                          else axes for name, axes in base[stack].items()}
    if "lm_head" in base:
        out["lm_head"] = q_axes(base["lm_head"])
    return out


def _quantizer(bits: int):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return _quantize_leaf if bits == 8 else _quantize_leaf_int4


def quantize_params(cfg: LlamaConfig, params: Params, bits: int = 8) -> Params:
    """A new tree with the projection weights, the expert weights and the
    LM head int8- or int4-quantized, on the parameters' device; the
    embedding in ``cfg.dtype``, everything else as given. A leaf that is
    already quantized at ``bits`` (a tree from ``init_quantized_params``)
    is kept as it is; one at the other width raises."""
    quant = _quantizer(bits)
    kind = "q8" if bits == 8 else "q4"

    def leaf(name: str, w):
        if name not in _QUANTIZED:
            return w
        if is_quantized(w):
            if kind not in w:
                raise ValueError(f"{name} is already quantized "
                                 f"({sorted(w)}), not to {bits} bits")
            return w
        return _quantize_stacked(w, quant)

    out: Params = {"tok_embed": params["tok_embed"].to(cfg.dtype),
                   "final_norm": params["final_norm"]}
    for stack in STACKS:
        if stack in params:
            out[stack] = {name: leaf(name, w)
                          for name, w in params[stack].items()}
    if "lm_head" in params:
        out["lm_head"] = leaf("lm_head", params["lm_head"])
    return out


def init_quantized_params(cfg: LlamaConfig, generator: torch.Generator,
                          bits: int, device=None) -> Params:
    """``quantize_params(cfg, init_params(cfg, generator, device), bits)``
    without the bf16 tree: each leaf is drawn in ``init_params``' order
    from ``generator`` (on ``device``), and a weight that quantizes is
    rounded to ``cfg.dtype`` and quantized one layer's row at a time as it
    is drawn. The peak beyond the result is one f32 row and its
    ``cfg.dtype`` copy (at Mixtral-8x7B one layer's 8 experts of one
    projection: 1.9 GB and 0.94 GB)."""
    cfg.validate_mla()
    quant = _quantizer(bits)
    dev = resolve_device(device)

    def make(name: str, shape):
        if name not in _QUANTIZED:
            out = torch.empty(shape, device=dev, dtype=torch.float32
                              if keeps_f32(name) else cfg.dtype)
            fill = init_fill(cfg, name)
            if fill is not None:
                return out.fill_(fill)
            for at, row in draw_rows(shape, generator, dev):
                out[at] = row
            return out
        out: dict = {}
        for at, row in draw_rows(shape, generator, dev):
            _quantize_into(out, tuple(shape[:-2]), at, row.to(cfg.dtype),
                           quant)
            del row
        return out

    params: Params = {}
    for stack, name, s in leaf_shapes(param_shapes(cfg)):
        if stack is None:
            params[name] = make(name, s)
        else:
            params.setdefault(stack, {})[name] = make(name, s)
    return params


def dequantize(w: dict) -> torch.Tensor:
    """The f32 weight a quantized leaf stands for, (..., in, out)."""
    if "q8" in w:
        return w["q8"].float() * w["scale"]
    q4, scale = w["q4"], w["scale"]
    lo = (q4 & 0xF).float() - 8
    hi = (q4 >> 4).float() - 8
    q = torch.stack((lo, hi), dim=-2).reshape(*q4.shape[:-2],
                                               2 * q4.shape[-2],
                                               q4.shape[-1])
    g = scale.shape[-3]
    qg = q.reshape(*q.shape[:-2], g, q.shape[-2] // g, q.shape[-1])
    return (qg * scale).reshape(q.shape)
