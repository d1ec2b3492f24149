"""Per-request sampling for the serving engine (port of the JAX package's
``workloads/serving/sampler.py``): seeded streams, temperature, top-k /
nucleus filtering, OpenAI presence/frequency penalties and logit_bias.

Draws come from a ``torch.Generator`` seeded from (request seed, draw
index), so a request samples the same way whatever slot it lands in and
whatever shares its batch. The stream differs from ``jax.random``'s:
sampled outputs match the JAX engine in distribution, not token by token.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _penalized(r) -> bool:
    return r is not None and (r.presence_penalty != 0.0
                              or r.frequency_penalty != 0.0)


def _bias_row(logit_bias: dict, vocab_size: int) -> np.ndarray:
    """Dense (V,) f32 additive row from an OpenAI logit_bias map."""
    row = np.zeros((vocab_size,), np.float32)
    for t, bias in logit_bias.items():
        row[int(t)] = float(bias)
    return row


def _apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                     presence: torch.Tensor,
                     frequency: torch.Tensor) -> torch.Tensor:
    """logits (B, V) minus presence once per seen token and frequency per
    occurrence, from per-slot token counts (B, V)."""
    c = counts.float()
    pen = presence[:, None] * (c > 0).float() + frequency[:, None] * c
    return logits.float() - pen


def _row_generator(seed: int, draw: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) & 0xFFFFFFFF) * 1_000_003 + int(draw))
    return g


def _filter(scaled: torch.Tensor, top_ks: torch.Tensor,
            top_ps: torch.Tensor) -> torch.Tensor:
    """Top-k and nucleus filtering of temperature-scaled (B, V) logits:
    kept entries unchanged, the rest -inf. top_k 0 keeps all; the nucleus
    keeps the smallest sorted prefix whose mass before each kept token is
    below top_p (so at least one token)."""
    v = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    ks = torch.where(top_ks > 0, top_ks, v)
    thresh_k = torch.gather(sorted_desc, 1,
                            (ks - 1).clamp(0, v - 1).long()[:, None])
    probs = torch.softmax(sorted_desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    keep = before < top_ps[:, None]
    idx_p = keep.sum(dim=-1) - 1
    thresh_p = torch.gather(sorted_desc, 1, idx_p[:, None])
    thresh = torch.maximum(thresh_k, thresh_p)
    return torch.where(scaled >= thresh, scaled,
                       torch.full_like(scaled, float("-inf")))


def _sample(logits: torch.Tensor, seeds: list[int], draws: list[int],
            temps: list[float], top_ks: Optional[list[int]] = None,
            top_ps: Optional[list[float]] = None) -> list[int]:
    """Per-row temperature + top-k + top-p sampling of (B, V) logits; rows
    with temperature <= 0 take the argmax. Row b draws from the generator
    of (seeds[b], draws[b])."""
    greedy = torch.argmax(logits, dim=-1)
    if all(t <= 0.0 for t in temps):
        return greedy.tolist()
    b = logits.shape[0]
    dev = logits.device
    t = torch.tensor(temps, dtype=torch.float32, device=dev)
    scaled = logits.float() / t.clamp(min=1e-6)[:, None]
    top_ks = top_ks or [0] * b
    top_ps = top_ps or [1.0] * b
    if any(k > 0 for k in top_ks) or any(p < 1.0 for p in top_ps):
        scaled = _filter(scaled,
                         torch.tensor(top_ks, dtype=torch.int64, device=dev),
                         torch.tensor(top_ps, dtype=torch.float32,
                                      device=dev))
    probs = torch.softmax(scaled, dim=-1)
    out = greedy.tolist()
    for i in range(b):
        if temps[i] > 0.0:
            g = _row_generator(seeds[i], draws[i], dev)
            out[i] = int(torch.multinomial(probs[i], 1, generator=g))
    return out
