from .keys import Key, PodEntry, DeviceTier, DEFAULT_TIER, tier_for_medium
from .token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
    DEFAULT_BLOCK_SIZE,
    hash_block,
    root_hash,
)

__all__ = [
    "Key",
    "PodEntry",
    "DeviceTier",
    "DEFAULT_TIER",
    "tier_for_medium",
    "ChunkedTokenDatabase",
    "TokenProcessorConfig",
    "DEFAULT_BLOCK_SIZE",
    "hash_block",
    "root_hash",
]
