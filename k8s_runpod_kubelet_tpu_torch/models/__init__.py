"""Llama-family models the port serves (dense attention, MLA, and the
Mixtral sparse-MoE MLP), and the one registry the serve CLI reads."""

from .llama import (LlamaConfig, LlamaModel, init_params, llama3_8b,
                    llama31_8b, mixtral_8x7b, mla_8b, tiny_llama, tiny_mla,
                    tiny_moe)

MODEL_CONFIGS = {
    "llama3-8b": llama3_8b,
    "llama31-8b": llama31_8b,
    "mla-8b": mla_8b,
    "mixtral-8x7b": mixtral_8x7b,
    "tiny": tiny_llama,
    "tiny-mla": tiny_mla,
    "tiny-moe": tiny_moe,
}

__all__ = ["LlamaConfig", "LlamaModel", "MODEL_CONFIGS", "init_params",
           "llama3_8b", "llama31_8b", "mixtral_8x7b", "mla_8b", "tiny_llama",
           "tiny_mla", "tiny_moe"]
