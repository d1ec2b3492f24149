"""Ops of the port: RMSNorm (Triton), paged attention over bf16 and int8
arenas, MLA latent attention over bf16 and int8 latent arenas, flash
attention with its gradients and the int4 matmul (CUDA C++), RoPE (plain
tensor code)."""

from .attention import (flash_attention, flash_dkv, flash_dq, flash_fwd,
                        paged_attention, paged_attention_mla,
                        paged_attention_mla_quant, paged_attention_multi,
                        paged_attention_multi_mla,
                        paged_attention_multi_mla_quant,
                        paged_attention_multi_quant, paged_attention_quant)
from .int4_matmul import int4_matmul
from .rmsnorm import rms_norm
from .rope import apply_rope, rope_frequencies

__all__ = ["apply_rope", "flash_attention", "flash_dkv", "flash_dq",
           "flash_fwd", "int4_matmul", "paged_attention",
           "paged_attention_mla", "paged_attention_mla_quant",
           "paged_attention_multi", "paged_attention_multi_mla",
           "paged_attention_multi_mla_quant", "paged_attention_multi_quant",
           "paged_attention_quant", "rms_norm", "rope_frequencies"]
