"""Ops of the serving path: RMSNorm (Triton), paged multi-token attention
(CUDA C++), RoPE (plain tensor code)."""

from .attention import paged_attention_multi
from .rmsnorm import rms_norm
from .rope import apply_rope, rope_frequencies

__all__ = ["apply_rope", "paged_attention_multi", "rms_norm",
           "rope_frequencies"]
