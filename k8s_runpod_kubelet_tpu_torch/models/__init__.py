"""Llama-family models the port serves (dense attention and MLA), and the
one registry the serve CLI reads."""

from .llama import (LlamaConfig, LlamaModel, init_params, llama3_8b,
                    llama31_8b, mla_8b, tiny_llama, tiny_mla)

MODEL_CONFIGS = {
    "llama3-8b": llama3_8b,
    "llama31-8b": llama31_8b,
    "mla-8b": mla_8b,
    "tiny": tiny_llama,
    "tiny-mla": tiny_mla,
}

__all__ = ["LlamaConfig", "LlamaModel", "MODEL_CONFIGS", "init_params",
           "llama3_8b", "llama31_8b", "mla_8b", "tiny_llama", "tiny_mla"]
