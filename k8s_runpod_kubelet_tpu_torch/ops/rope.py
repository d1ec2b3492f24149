"""Rotary position embeddings, Llama-3 style (port of the JAX package's
``ops/rope.py``). Elementwise tensor code: the JAX package left it to XLA,
and the port leaves it to PyTorch.

Scaling: none, the Llama-3.1 NTK recipe (``llama31-8b``), plain linear
interpolation and HF's "default". YaRN waits for the MLA models and is
refused here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def rope_frequencies(head_dim: int, max_seq_len: int,
                     theta: float = 500_000.0,
                     scaling: Optional[dict] = None,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape (max_seq_len, head_dim // 2), f32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    rope_type = (scaling or {}).get("rope_type",
                                    (scaling or {}).get("type", "llama3"))
    if scaling and rope_type == "linear":
        inv_freq = inv_freq / scaling.get("factor", 1.0)
    elif scaling and rope_type == "default":
        pass
    elif scaling and rope_type != "llama3":
        raise ValueError(f"unsupported rope_scaling type {rope_type!r} "
                         "(supported: linear, llama3, default)")
    elif scaling:
        factor = scaling.get("factor", 8.0)
        low = scaling.get("low_freq_factor", 1.0)
        high = scaling.get("high_freq_factor", 4.0)
        orig = scaling.get("original_max_position",
                           scaling.get("original_max_position_embeddings",
                                       8192))
        wavelen = 2 * math.pi / inv_freq
        low_wl = orig / low
        high_wl = orig / high
        smooth = (orig / wavelen - low) / (high - low)
        inv_freq = torch.where(
            wavelen > low_wl, inv_freq / factor,
            torch.where(wavelen < high_wl, inv_freq,
                        (1 - smooth) * inv_freq / factor + smooth * inv_freq))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate (B, S, H, D) by position; ``positions`` (B, S) overrides
    arange. Math in f32, result in x's dtype."""
    b, s, h, d = x.shape
    if positions is None:
        c = cos[:s][None, :, None, :]
        si = sin[:s][None, :, None, :]
    else:
        c = cos[positions][:, :, None, :]
        si = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * si, x2 * c + x1 * si], dim=-1)
    return out.to(x.dtype)
