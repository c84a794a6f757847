from .keys import Key, PodEntry, DeviceTier, DEFAULT_TIER, tier_for_medium
from .index import (
    Index,
    IndexConfig,
    InMemoryIndexConfig,
    CostAwareMemoryIndexConfig,
    NativeMemoryIndexConfig,
    RedisIndexConfig,
    create_index,
)
from .in_memory import InMemoryIndex
from .cost_aware import CostAwareMemoryIndex
from .instrumented import InstrumentedIndex
from .native_memory import NativeMemoryIndex, native_available
from .token_processor import (
    ChunkedTokenDatabase,
    TokenProcessorConfig,
    DEFAULT_BLOCK_SIZE,
    hash_block,
    root_hash,
)

__all__ = [
    "Index",
    "IndexConfig",
    "InMemoryIndexConfig",
    "CostAwareMemoryIndexConfig",
    "RedisIndexConfig",
    "create_index",
    "InMemoryIndex",
    "CostAwareMemoryIndex",
    "InstrumentedIndex",
    "NativeMemoryIndexConfig",
    "NativeMemoryIndex",
    "native_available",
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
