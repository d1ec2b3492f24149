"""Rotary position embeddings, Llama-3 style (port of the JAX package's
``ops/rope.py``). Elementwise tensor code: the JAX package left it to XLA,
and the port leaves it to PyTorch.

Scaling: none, the Llama-3.1 NTK recipe (``llama31-8b``), plain linear
interpolation, HF's "default", and YaRN (the DeepSeek MLA models), whose
attention factor is folded into the cos/sin tables as the JAX package
folds it. YaRN's softmax half (``mscale_all_dim``) lives at the attention
call sites: ``models/llama.py:yarn_mscale_sq``.
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
    inv_freq, af = inv_frequencies(head_dim, max_seq_len, theta, scaling,
                                   device)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    if af != 1.0:
        return torch.cos(freqs) * af, torch.sin(freqs) * af
    return torch.cos(freqs), torch.sin(freqs)


def inv_frequencies(head_dim: int, max_seq_len: int,
                    theta: float = 500_000.0,
                    scaling: Optional[dict] = None,
                    device=None) -> tuple[torch.Tensor, float]:
    """The f32 rotation frequencies (head_dim // 2,) after ``scaling``, and
    the factor the tables carry (YaRN's attention factor, else 1)."""
    af = 1.0   # YaRN's attention factor, folded into the tables
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    rope_type = (scaling or {}).get("rope_type",
                                    (scaling or {}).get("type", "llama3"))
    if scaling and rope_type == "linear":
        inv_freq = inv_freq / scaling.get("factor", 1.0)
    elif scaling and rope_type == "default":
        pass
    elif scaling and rope_type == "yarn":
        inv_freq, af = _yarn(inv_freq, head_dim, max_seq_len, theta,
                             scaling)
    elif scaling and rope_type != "llama3":
        raise ValueError(f"unsupported rope_scaling type {rope_type!r} "
                         "(supported: linear, llama3, yarn, default)")
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
    return inv_freq, af


def _yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _yarn(inv_freq: torch.Tensor, head_dim: int, max_seq_len: int,
          theta: float, scaling: dict) -> tuple[torch.Tensor, float]:
    """YaRN (arXiv:2309.00071) as transformers' ``_compute_yarn_parameters``
    and the JAX package compute it: per frequency, a linear ramp in
    rotations over the original window blends interpolation (freq /
    factor) with extrapolation (the raw freq). Returns the blended
    frequencies and the attention factor for the tables."""
    factor = float(scaling.get("factor", 1.0))
    orig = float(scaling.get("original_max_position_embeddings",
                             scaling.get("original_max_position",
                                         max_seq_len)))
    beta_fast = float(scaling.get("beta_fast") or 32)
    beta_slow = float(scaling.get("beta_slow") or 1)
    attention_factor = scaling.get("attention_factor")
    if attention_factor is None:
        ms, ms_all = scaling.get("mscale"), scaling.get("mscale_all_dim")
        if ms and ms_all:
            attention_factor = (_yarn_mscale(factor, ms)
                                / _yarn_mscale(factor, ms_all))
        else:
            attention_factor = _yarn_mscale(factor)

    def corr_dim(n_rot: float) -> float:
        return (head_dim * math.log(orig / (n_rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low, high = corr_dim(beta_fast), corr_dim(beta_slow)
    if scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=inv_freq.device) - low)
                       / (high - low), 0, 1)
    extrapolation = 1.0 - ramp
    inv_freq = ((inv_freq / factor) * (1 - extrapolation)
                + inv_freq * extrapolation)
    return inv_freq, float(attention_factor)


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
