"""Dense Llama-family models the port serves, and the one registry the
serve CLI reads."""

from .llama import (LlamaConfig, LlamaModel, init_params, llama3_8b,
                    llama31_8b, tiny_llama)

MODEL_CONFIGS = {
    "llama3-8b": llama3_8b,
    "llama31-8b": llama31_8b,
    "tiny": tiny_llama,
}

__all__ = ["LlamaConfig", "LlamaModel", "MODEL_CONFIGS", "init_params",
           "llama3_8b", "llama31_8b", "tiny_llama"]
