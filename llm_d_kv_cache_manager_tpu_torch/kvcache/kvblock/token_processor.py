"""Tokens → chained KV-block keys, bit-exact with the serving engine.

Parity with reference ``pkg/kvcache/kvblock/token_processor.go``:

- tokens are chunked into blocks of ``block_size`` (default 16, vLLM's
  default; reference ``token_processor.go:32``); **no partial blocks**
  (``:136-148``);
- per-chunk hash = low 8 bytes, big-endian, of SHA-256 over the canonical
  CBOR encoding of ``[parent_hash, token_chunk, extra=None]``
  (``:105-122``);
- the root parent hash = low 8 bytes of SHA-256 over canonical CBOR of the
  ``hash_seed`` string (``:80-101``), which must equal the serving engine's
  hash seed (vLLM: ``PYTHONHASHSEED``) for read-path hashes to line up with
  engine-emitted event hashes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence

from .cbor import dumps_canonical
from .keys import Key

DEFAULT_BLOCK_SIZE = 16


def _low64_be(digest: bytes) -> int:
    return int.from_bytes(digest[24:32], "big")


def hash_block(parent: int, tokens: Sequence[int], extra=None) -> int:
    """One link of the chain: uint64 hash of (parent, tokens, extra).

    Token ids are masked to uint32 (the engine-side token dtype), so
    out-of-range Python ints can never silently produce hashes the serving
    engine would not emit.
    """
    payload = dumps_canonical([parent, [int(t) & 0xFFFFFFFF for t in tokens], extra])
    return _low64_be(hashlib.sha256(payload).digest())


def root_hash(seed: str = "") -> int:
    """Root parent hash derived from the deployment-wide hash seed."""
    return _low64_be(hashlib.sha256(dumps_canonical(seed)).digest())


@dataclass
class TokenProcessorConfig:
    block_size: int = DEFAULT_BLOCK_SIZE
    # Must be aligned with the serving engine's seed (reference
    # token_processor.go:37-40). Empty string matches vLLM with
    # PYTHONHASHSEED unset-equivalent deployments.
    hash_seed: str = ""


class ChunkedTokenDatabase:
    """Converts token sequences into chained KV-block keys."""

    def __init__(self, config: Optional[TokenProcessorConfig] = None):
        self.config = config or TokenProcessorConfig()
        if self.config.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.config.block_size}")
        self._init_hash = root_hash(self.config.hash_seed)

    @property
    def init_hash(self) -> int:
        return self._init_hash

    def chunk_tokens(self, tokens: Sequence[int]) -> list[Sequence[int]]:
        bs = self.config.block_size
        n = (len(tokens) // bs) * bs  # no partial blocks
        return [tokens[i : i + bs] for i in range(0, n, bs)]

    def prefix_hashes(self, tokens: Sequence[int]) -> list[int]:
        """Chained hashes for each complete block of ``tokens``."""
        prefix = self._init_hash
        out = []
        for chunk in self.chunk_tokens(tokens):
            prefix = hash_block(prefix, chunk, None)
            out.append(prefix)
        return out

    def tokens_to_kv_block_keys(self, tokens: Sequence[int], model_name: str) -> list[Key]:
        return [Key(model_name, h) for h in self.prefix_hashes(tokens)]
