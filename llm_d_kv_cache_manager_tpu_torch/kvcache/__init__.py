"""Framework-free KV-cache control plane: the block-hash chain and the
index backends (``kvblock``), the KV-event wire and its ingestion pool
(``kvevents``), the longest-prefix scorer and the indexer that ties them
to tokenization, the chain-hash-sharded plane (``sharding``), the
predicted-TTFT model (``predictor``), the fleet router that blends index
score, routed affinity and load (``router``) and the KV-transfer plane
(``transfer``). The exports are the JAX package's."""

from . import kvblock  # noqa: F401
from . import transfer  # noqa: F401
from .indexer import KVCacheIndexer, KVCacheIndexerConfig
from .predictor import (
    PodSignals,
    PredictionCorrector,
    TTFTPredictor,
    TTFTPredictorConfig,
)
from .router import (
    BlendedRouter,
    DisaggPlan,
    PlanError,
    PodView,
    PrefixAffinityTracker,
    RoutingDecision,
    TwoHopPlanner,
)
from .scorer import (
    KVBlockScorer,
    KVBlockScorerConfig,
    LongestPrefixScorer,
    ScoringStrategy,
    new_scorer,
)
from .sharding import (
    HashRing,
    ShardedEventsPool,
    ShardedEventsPoolConfig,
    ShardedIndex,
)

__all__ = [
    "BlendedRouter",
    "DisaggPlan",
    "PlanError",
    "PodView",
    "TwoHopPlanner",
    "PrefixAffinityTracker",
    "RoutingDecision",
    "kvblock",
    "transfer",
    "KVCacheIndexer",
    "KVCacheIndexerConfig",
    "PodSignals",
    "PredictionCorrector",
    "TTFTPredictor",
    "TTFTPredictorConfig",
    "KVBlockScorer",
    "KVBlockScorerConfig",
    "LongestPrefixScorer",
    "ScoringStrategy",
    "new_scorer",
    "HashRing",
    "ShardedEventsPool",
    "ShardedEventsPoolConfig",
    "ShardedIndex",
]
