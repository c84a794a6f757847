"""Framework-free KV-cache control plane: the block-hash chain and the
index backends (``kvblock``), the KV-event wire and its ingestion pool
(``kvevents``), the longest-prefix scorer and the indexer that ties them
to tokenization, the chain-hash-sharded plane (``sharding``), the
predicted-TTFT model (``predictor``) and the KV-transfer plane
(``transfer``)."""

from . import kvblock  # noqa: F401
from .indexer import KVCacheIndexer, KVCacheIndexerConfig

__all__ = ["kvblock", "KVCacheIndexer", "KVCacheIndexerConfig"]
