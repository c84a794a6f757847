from .llama import (
    LLAMA_3_8B,
    TINY_GEMMA,
    TINY_LLAMA,
    LlamaConfig,
    decode_step,
    decode_steps,
    init_kv_pages,
    init_params,
    prefill,
)
from .convert import params_from_jax

__all__ = [
    "LLAMA_3_8B",
    "TINY_GEMMA",
    "TINY_LLAMA",
    "LlamaConfig",
    "decode_step",
    "decode_steps",
    "init_kv_pages",
    "init_params",
    "prefill",
    "params_from_jax",
]
