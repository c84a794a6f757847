"""Alternative prefix store: character trie (bounded).

Parity with reference ``pkg/tokenization/prefixstore/trie_store.go``: a
per-model character trie where each node records the tokens that become
fully contained once the prefix reaches that character (token ``[, high]``
byte offset ≤ the node's byte position). Lookup walks the prompt until the
first unseen character, collecting newly-contained tokens and the covered
ratio. Not the default: slower than the LRU store (reference
``docs/architecture.md:159-160``).

Design deviations from the reference (all three are fixes):

- nodes store *all* newly-contained token ids at their position rather than
  only the last one — the reference drops intermediate tokens when several
  (e.g. zero-width specials) become contained at the same character;
- each insert stamps its path with a generation, and lookups stop at the
  first generation change — the reference happily splices token indexes
  from different tokenizations that overwrote each other's shared-prefix
  nodes, returning corrupted sequences with full overlap ratio;
- growth is bounded (the reference grows without limit,
  ``trie_store.go`` has no eviction): per-model node count is capped at
  ``Config.trie_max_nodes`` by pruning stale-generation subtrees — which
  the generation rule above already makes unreachable to lookups, so the
  prune is lossless — then truncating the live path's tail if a single
  tokenization alone exceeds the budget; model tries are LRU-evicted
  beyond ``MAX_MODELS``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence

from .indexer import Config, Indexer, Offset


class _Node:
    __slots__ = ("children", "new_tokens", "last_index", "gen")

    def __init__(self):
        self.children: dict[str, _Node] = {}
        # token ids newly contained at this node, and the index of the last
        # contained token in the full tokenization (-1 = none).
        self.new_tokens: list[int] = []
        self.last_index: int = -1
        # generation of the insert that last wrote this node. Every insert
        # rewrites a contiguous path from the root, so along any root path
        # generations are non-increasing; mixing nodes from different
        # generations would splice token indexes from different
        # tokenizations, so lookups stop at the first generation change.
        self.gen: int = 0


class ContainedTokenStore(Indexer):
    #: model tries kept; least-recently-used beyond this are dropped whole.
    MAX_MODELS = 64

    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config()
        self._mu = threading.RLock()
        self._tries: OrderedDict[str, _Node] = OrderedDict()  # guarded_by: _mu
        self._counts: dict[str, int] = {}  # nodes per model  # guarded_by: _mu
        self._gen = 0  # guarded_by: _mu

    def _trie(self, model_name: str, create: bool) -> Optional[_Node]:  # kvlint: holds=_mu
        trie = self._tries.get(model_name)
        if trie is None and create:
            trie = _Node()
            self._tries[model_name] = trie
            self._counts[model_name] = 1
            while len(self._tries) > self.MAX_MODELS:
                evicted, _ = self._tries.popitem(last=False)
                del self._counts[evicted]
        if trie is not None:
            self._tries.move_to_end(model_name)
        return trie

    def node_count(self, model_name: str) -> int:
        """Nodes currently held for ``model_name`` (bounded diagnostics)."""
        with self._mu:
            return self._counts.get(model_name, 0)

    def _enforce_budget(self, model_name: str, root: _Node) -> None:  # kvlint: holds=_mu
        """Cap the model trie at ``config.trie_max_nodes`` nodes.

        First prune subtrees whose generation is stale: the lookup rule
        (stop at the first generation change from the root's) makes them
        unreachable already, so dropping them changes no lookup result.
        What survives is the single chain written by the latest insert; if
        that alone exceeds the budget, truncate its tail.
        """
        budget = max(2, self.config.trie_max_nodes)
        if self._counts[model_name] <= budget:
            return
        live_gen = root.gen
        node = root
        kept = 1
        while True:
            live = None
            for ch, child in node.children.items():
                if child.gen == live_gen:
                    live = (ch, child)
                    break  # one insert writes one path: ≤1 live child
            if live is None:
                node.children.clear()
                break
            if kept + 1 > budget:  # live path alone exceeds the budget
                node.children.clear()
                break
            node.children = {live[0]: live[1]}
            node = live[1]
            kept += 1
        self._counts[model_name] = kept

    def add_tokenization(
        self,
        model_name: str,
        prompt: str,
        tokens: Sequence[int],
        offsets: Sequence[Offset],
    ) -> None:
        if not prompt or not tokens:
            return
        if len(tokens) != len(offsets):
            raise ValueError("tokens and offsets must be parallel")

        with self._mu:
            self._gen += 1
            gen = self._gen
            node = self._trie(model_name, create=True)
            # Tokens contained before any character (zero-width specials at
            # position 0) attach to the root.
            k = -1
            root_new = []
            while k + 1 < len(tokens) and offsets[k + 1][1] <= 0:
                k += 1
                root_new.append(int(tokens[k]))
            node.new_tokens = root_new
            node.last_index = k
            node.gen = gen

            byte_pos = 0
            created = 0
            for ch in prompt:
                byte_pos += len(ch.encode("utf-8"))
                new_here: list[int] = []
                while k + 1 < len(tokens) and offsets[k + 1][1] <= byte_pos:
                    k += 1
                    new_here.append(int(tokens[k]))
                child = node.children.get(ch)
                if child is None:
                    child = _Node()
                    node.children[ch] = child
                    created += 1
                node = child
                node.new_tokens = new_here
                node.last_index = k
                node.gen = gen
            self._counts[model_name] += created
            self._enforce_budget(model_name, self._tries[model_name])

    def find_longest_contained_tokens(
        self, prompt: str, model_name: str
    ) -> tuple[list[int], float]:
        with self._mu:
            node = self._trie(model_name, create=False)
            if node is None or not prompt:
                return [], 0.0

            contained: list[int] = []
            expected_gen = node.gen  # root carries the latest insert's gen
            contained.extend(node.new_tokens)

            matched_chars = 0
            for ch in prompt:
                child = node.children.get(ch)
                if child is None or child.gen != expected_gen:
                    # gen change = this subpath was written by a different
                    # (older) tokenization than the nodes already collected;
                    # splicing them would corrupt the sequence.
                    break
                node = child
                matched_chars += 1
                contained.extend(node.new_tokens)
            return contained, matched_chars / len(prompt)
