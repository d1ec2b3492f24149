"""Llama-family models the port serves (dense attention, MLA, and the
Mixtral sparse-MoE MLP), LoRA adapters on them, and the one registry the
serve CLI reads."""

from .llama import (LlamaConfig, LlamaModel, init_params, llama3_8b,
                    llama31_8b, mixtral_8x7b, mla_8b, tiny_llama, tiny_mla,
                    tiny_moe)
from .lora import (LORA_TARGETS, LoraConfig, apply_lora, extract_adapter,
                   is_lora, load_adapter, lora_mask, lora_param_count,
                   merge_lora, save_adapter)

MODEL_CONFIGS = {
    "llama3-8b": llama3_8b,
    "llama31-8b": llama31_8b,
    "mla-8b": mla_8b,
    "mixtral-8x7b": mixtral_8x7b,
    "tiny": tiny_llama,
    "tiny-mla": tiny_mla,
    "tiny-moe": tiny_moe,
}

__all__ = ["LORA_TARGETS", "LlamaConfig", "LlamaModel", "LoraConfig",
           "MODEL_CONFIGS", "apply_lora", "extract_adapter", "init_params",
           "is_lora", "llama3_8b", "llama31_8b", "load_adapter", "lora_mask",
           "lora_param_count", "merge_lora", "mixtral_8x7b", "mla_8b",
           "save_adapter", "tiny_llama", "tiny_mla", "tiny_moe"]
