"""KV-cache Indexer: the read-path orchestrator.

Parity with reference ``pkg/kvcache/indexer.go``: wires the tokenization
pool (with prefix store), the token→block-key processor, the block index,
and the scorer; ``get_pod_scores`` is the hot RPC
(``indexer.go:117-151``):

    prompt → tokenize (prefix-store fast path) → chunk+hash → index lookup
           → longest-prefix score → {pod: score}
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..tokenization import TokenizationPool, TokenizationPoolConfig
from ..tokenization.prefixstore import Indexer as PrefixStoreIndexer
from ..tokenization.tokenizer import Tokenizer
from ..utils import get_logger
from .kvblock import (
    ChunkedTokenDatabase,
    Index,
    IndexConfig,
    TokenProcessorConfig,
    create_index,
)
from .kvblock.keys import Key
from .scorer import KVBlockScorer, KVBlockScorerConfig, ScoringStrategy, new_scorer

log = get_logger("kvcache.indexer")


@dataclass
class KVCacheIndexerConfig:
    """Composed config, one member per component
    (reference ``indexer.go:35-52``)."""

    token_processor: TokenProcessorConfig = field(default_factory=TokenProcessorConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    scorer: KVBlockScorerConfig = field(default_factory=KVBlockScorerConfig)
    tokenization_pool: TokenizationPoolConfig = field(default_factory=TokenizationPoolConfig)


class KVCacheIndexer:
    """Orchestrates scoring requests for KV-cache-aware routing."""

    def __init__(
        self,
        config: Optional[KVCacheIndexerConfig] = None,
        *,
        index: Optional[Index] = None,
        tokenizer: Optional[Tokenizer] = None,
        prefix_store: Optional[PrefixStoreIndexer] = None,
        fleet_health=None,
    ):
        """``fleet_health`` (a ``kvevents.FleetHealth``, optional): when
        attached, every score map is filtered through its routability view
        so a pod past ``pod_ttl_s``, one that published a ``PodDrained``
        goodbye, or one advertising ``draining`` in its heartbeats is
        never returned to the router — even in the window between expiry
        and the dead-pod sweep landing."""
        self.config = config or KVCacheIndexerConfig()
        self.fleet_health = fleet_health
        self.token_processor = ChunkedTokenDatabase(self.config.token_processor)
        self.kv_block_index: Index = (
            index if index is not None else create_index(self.config.index)
        )
        self.scorer: KVBlockScorer = new_scorer(self.config.scorer)
        self.tokenization_pool = TokenizationPool(
            self.config.tokenization_pool, store=prefix_store, tokenizer=tokenizer
        )
        # Fused native paths: lookup+score in one C++ call when the backend
        # offers it and the strategy matches (NativeMemoryIndex).
        fused_ok = self.scorer.strategy == ScoringStrategy.LONGEST_PREFIX
        self._fused_score = (
            getattr(self.kv_block_index, "score_longest_prefix", None)
            if fused_ok
            else None
        )
        self._fused_hash_score = (
            getattr(self.kv_block_index, "score_hashes", None) if fused_ok else None
        )

    # -- lifecycle ----------------------------------------------------------
    def run(self) -> None:
        """Start background workers (reference ``Indexer.Run``)."""
        self.tokenization_pool.run()

    def shutdown(self) -> None:
        self.tokenization_pool.shutdown()

    # -- the hot RPC --------------------------------------------------------
    def get_pod_scores(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Optional[Sequence[str]] = None,
        placement: Optional[str] = None,
    ) -> dict[str, int]:
        """Score candidate pods by longest consecutive cached-prefix match
        for ``prompt``. Empty/None ``pod_identifiers`` scores all known pods.
        ``placement`` ("prefill"/"decode"; None = legacy, role-blind)
        excludes pods whose heartbeat-advertised role cannot serve that
        tier — a prefill-only pod never wins decode placement and vice
        versa (disaggregated serving)."""
        tokens = self.tokenization_pool.tokenize(prompt, model_name)
        log.debug("tokenized prompt", n_tokens=len(tokens), model=model_name)

        block_keys = self.token_processor.tokens_to_kv_block_keys(tokens, model_name)
        log.debug("computed block keys", n_keys=len(block_keys))
        if not block_keys:
            return {}

        pod_filter = set(pod_identifiers) if pod_identifiers else set()
        scores = self._lookup_and_score(block_keys, pod_filter, placement)
        log.debug("scored pods", scores=scores)
        return scores

    def score_tokens(
        self,
        tokens: Sequence[int],
        model_name: str,
        pod_identifiers: Optional[Sequence[str]] = None,
        placement: Optional[str] = None,
    ) -> dict[str, int]:
        """Scoring entry for callers that already hold token ids (the in-tree
        JAX server's router path — skips the tokenizer pool hop)."""
        pod_filter = set(pod_identifiers) if pod_identifiers else set()
        if self._fused_hash_score is not None:
            # Zero-object hot path: C++ hash chain → C++ fused lookup+score;
            # no Key instances are built at all.
            hashes = self.token_processor.prefix_hashes(tokens)
            if not hashes:
                return {}
            return self._filter_expired(
                self._fused_hash_score(model_name, hashes, pod_filter), placement
            )
        block_keys = self.token_processor.tokens_to_kv_block_keys(tokens, model_name)
        if not block_keys:
            return {}
        return self._lookup_and_score(block_keys, pod_filter, placement)

    def signal_views(
        self, pods: Optional[Sequence[str]] = None
    ) -> dict[str, dict]:
        """Heartbeat-derived per-pod signal state (age / draining /
        expired / role) for predicted-TTFT routing — the scorer-embedded
        predictor merges these with the caller-supplied serving
        telemetry (queue depth, prefill rate). ``pods`` scopes the
        locked walk to the named pods (per-request callers). ``{}``
        without an attached ``FleetHealth``: every signal then reads as
        fresh, which is exactly the in-process single-binary case."""
        if self.fleet_health is None:
            return {}
        return self.fleet_health.signal_views(pods)

    def _filter_expired(
        self, scores: dict[str, int], placement: Optional[str] = None
    ) -> dict[str, int]:
        """Routability guard: an expired, drained, or draining pod must
        never win routing, even when its swept-in-the-index state lags its
        expiry (sweeper cadence) or its entries have not been evicted yet
        (drain still in progress). ``placement`` adds the role gate."""
        if self.fleet_health is None or not scores:
            return scores
        return self.fleet_health.filter_scores(scores, placement)

    def _lookup_and_score(
        self,
        block_keys: list[Key],
        pod_filter: set[str],
        placement: Optional[str] = None,
    ) -> dict[str, int]:
        if self._fused_score is not None:
            scores = self._fused_score(block_keys, pod_filter)
            if scores is not None:
                return self._filter_expired(scores, placement)
        key_to_pods = self.kv_block_index.lookup(block_keys, pod_filter)
        return self._filter_expired(
            self.scorer.score(block_keys, key_to_pods), placement
        )
