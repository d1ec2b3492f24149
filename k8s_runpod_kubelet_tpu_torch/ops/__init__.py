"""Ops of the port: RMSNorm (Triton), paged multi-token attention and flash
attention with its gradients (CUDA C++), RoPE (plain tensor code)."""

from .attention import (flash_attention, flash_dkv, flash_dq, flash_fwd,
                        paged_attention_multi)
from .rmsnorm import rms_norm
from .rope import apply_rope, rope_frequencies

__all__ = ["apply_rope", "flash_attention", "flash_dkv", "flash_dq",
           "flash_fwd", "paged_attention_multi", "rms_norm",
           "rope_frequencies"]
