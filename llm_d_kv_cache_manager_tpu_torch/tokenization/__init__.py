from .pool import TokenizationError, TokenizationPool, TokenizationPoolConfig
from .tokenizer import (
    CachedHFTokenizer,
    HFTokenizerConfig,
    Tokenizer,
    char_offsets_to_byte_offsets,
)
from . import prefixstore  # noqa: F401

__all__ = [
    "TokenizationError",
    "TokenizationPool",
    "TokenizationPoolConfig",
    "CachedHFTokenizer",
    "HFTokenizerConfig",
    "Tokenizer",
    "char_offsets_to_byte_offsets",
    "prefixstore",
]
