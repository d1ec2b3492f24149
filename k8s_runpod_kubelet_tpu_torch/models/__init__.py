"""Llama-family models the port serves (dense attention, with the Gemma
(7B, 2 and 3), Mistral, Qwen2 and Qwen3 branches, MLA, the Mixtral
sparse-MoE MLP and DeepSeek-MoE),
LoRA adapters on them, and the one registry the serve CLI reads."""

from .llama import (LlamaConfig, LlamaModel, deepseek_v2_lite, deepseek_v3,
                    gemma2_9b, gemma3_12b, gemma_7b, init_params,
                    llama3_8b, llama3_70b, llama31_8b, mistral_7b,
                    mixtral_8x7b, mla_8b, qwen2_7b, qwen3_8b, tiny_llama,
                    tiny_mla, tiny_moe)
from .lora import (LORA_TARGETS, LoraConfig, apply_lora, extract_adapter,
                   is_lora, load_adapter, lora_mask, lora_param_count,
                   merge_lora, save_adapter)

MODEL_CONFIGS = {
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "llama31-8b": llama31_8b,
    "gemma-7b": gemma_7b,
    "gemma2-9b": gemma2_9b,
    "gemma3-12b": gemma3_12b,
    "mistral-7b": mistral_7b,
    "qwen2-7b": qwen2_7b,
    "qwen3-8b": qwen3_8b,
    "mla-8b": mla_8b,
    "mixtral-8x7b": mixtral_8x7b,
    "deepseek-v2-lite": deepseek_v2_lite,
    "deepseek-v3": deepseek_v3,
    "tiny": tiny_llama,
    "tiny-mla": tiny_mla,
    "tiny-moe": tiny_moe,
}

__all__ = ["LORA_TARGETS", "LlamaConfig", "LlamaModel", "LoraConfig",
           "MODEL_CONFIGS", "apply_lora", "deepseek_v2_lite", "deepseek_v3",
           "extract_adapter", "gemma2_9b",
           "gemma3_12b", "gemma_7b",
           "init_params", "is_lora", "llama3_8b", "llama3_70b", "llama31_8b",
           "load_adapter", "lora_mask", "lora_param_count", "merge_lora",
           "mistral_7b", "mixtral_8x7b", "mla_8b", "qwen2_7b", "qwen3_8b",
           "save_adapter", "tiny_llama", "tiny_mla", "tiny_moe"]
