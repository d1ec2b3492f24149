"""Weight-only int8 and int4 quantization for serving (port of the JAX
package's ``models/quant.py``).

A quantized weight is a dict leaf: ``{"q8": int8 (..., in, out), "scale":
f32 (..., 1, out)}`` (per output channel, absmax / 127) or ``{"q4": uint8
(..., in/2, out), "scale": f32 (..., g, 1, out)}`` (groups of
``INT4_GROUP`` contraction elements, absmax / 7; in-element 2i in the low
nibble, 2i+1 in the high, each stored offset by 8). ``llama._mm`` takes
either form. The embedding is stored in the compute dtype, norms stay
f32, the LM head is quantized.

The JAX package quantizes on the host in numpy. This port quantizes in
torch on the parameters' device, one layer slice at a time, so an 8B
model never needs an f32 copy of more than one slice; the arithmetic is
the same (f32 absmax, the 1e-8 floor, an f32 divide, round half to even,
clip, pack), and on the CPU the result is bit-identical to the JAX
quantizer's.
"""

from __future__ import annotations

from typing import Any

import torch

from .llama import LlamaConfig, Params

__all__ = ["INT4_GROUP", "dequantize", "is_quantized", "quantize_params"]

# stacked-layer projection weights, plus the LM head. MLA: w_dkv and the
# low-rank q pair quantize as the JAX quantizer's do; w_uk/w_uv stay in
# full precision (the absorbed step folds them in f32, not through _mm)
_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "w_dkv", "w_qa", "w_qb")

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


def _quantize_stacked(w: torch.Tensor, quant) -> dict[str, torch.Tensor]:
    """Quantize a (L, in, out) leaf one layer slice at a time into
    preallocated outputs (a 2-D leaf is one slice)."""
    if w.dim() == 2:
        return quant(w)
    first = quant(w[0])
    out = {k: torch.empty((w.shape[0],) + v.shape, dtype=v.dtype,
                          device=v.device) for k, v in first.items()}
    for k, v in first.items():
        out[k][0] = v
    del first
    for layer in range(1, w.shape[0]):
        for k, v in quant(w[layer]).items():
            out[k][layer] = v
    return out


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and ("q8" in w or "q4" in w)


def quantize_params(cfg: LlamaConfig, params: Params, bits: int = 8) -> Params:
    """A new tree with the projection weights and the LM head int8- or
    int4-quantized, on the parameters' device; the embedding in
    ``cfg.dtype``, everything else as given."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    quant = _quantize_leaf if bits == 8 else _quantize_leaf_int4
    out: Params = {"tok_embed": params["tok_embed"].to(cfg.dtype),
                   "final_norm": params["final_norm"]}
    out["layers"] = {
        name: (_quantize_stacked(w, quant) if name in _LAYER_WEIGHTS else w)
        for name, w in params["layers"].items()}
    if "lm_head" in params:
        out["lm_head"] = _quantize_stacked(params["lm_head"], quant)
    return out


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
