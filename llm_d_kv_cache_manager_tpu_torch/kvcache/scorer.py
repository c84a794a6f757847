"""Pod scoring strategies.

Parity with reference ``pkg/kvcache/kvblock_scorer.go``: score = length of
the longest *consecutive* block-hit streak starting from block 0. The active
pod set seeds from key[0]'s pods and intersects per subsequent key; survivors
increment (``kvblock_scorer.go:77-111``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import Sequence

from .kvblock import Key


class ScoringStrategy(str, Enum):
    LONGEST_PREFIX = "LongestPrefixMatch"


@dataclass
class KVBlockScorerConfig:
    scoring_strategy: ScoringStrategy = ScoringStrategy.LONGEST_PREFIX


class KVBlockScorer(ABC):
    @property
    @abstractmethod
    def strategy(self) -> ScoringStrategy: ...

    @abstractmethod
    def score(
        self, keys: Sequence[Key], key_to_pods: dict[Key, list[str]]
    ) -> dict[str, int]:
        """Return pod → score for the given ordered key chain and hit map."""


class LongestPrefixScorer(KVBlockScorer):
    @property
    def strategy(self) -> ScoringStrategy:
        return ScoringStrategy.LONGEST_PREFIX

    def score(
        self, keys: Sequence[Key], key_to_pods: dict[Key, list[str]]
    ) -> dict[str, int]:
        pod_scores: dict[str, int] = {}
        if not keys:
            return pod_scores

        first_pods = key_to_pods.get(keys[0], [])
        active = set(first_pods)
        for pod in first_pods:
            pod_scores[pod] = 1

        for key in keys[1:]:
            if not active:
                break
            active &= set(key_to_pods.get(key, []))
            for pod in active:
                pod_scores[pod] += 1

        return pod_scores


def new_scorer(config: KVBlockScorerConfig | None = None) -> KVBlockScorer:
    cfg = config or KVBlockScorerConfig()
    if cfg.scoring_strategy == ScoringStrategy.LONGEST_PREFIX:
        return LongestPrefixScorer()
    raise ValueError(f"unsupported scoring strategy: {cfg.scoring_strategy}")
