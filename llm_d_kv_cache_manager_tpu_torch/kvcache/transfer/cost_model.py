"""Transfer-vs-recompute cost model for the routing decision.

Same philosophy as the engine's host-tier admission model and the
cost-aware index's budget accounting: decisions come from MEASURED rates
of this deployment, never from assumed constants — a fast-DCN fleet pulls
aggressively, a slow link makes the model fall back to classic routing,
and until both rates have samples the model abstains ("route_warm" =
exactly the legacy router).

Per request the router asks: the warmest pod holds ``warm_blocks`` of this
prompt's prefix but carries ``warm_load`` outstanding requests; the
least-loaded pod is cold. Three options are costed end-to-end:

- ``route_warm``  — queue behind the warm pod, prefill only the suffix;
- ``pull``        — land on the cold pod, DMA the warm prefix over the
  transfer channel, prefill only the suffix;
- ``cold``        — land on the cold pod, recompute the whole prompt.

Queueing is modeled as ``load x est_service_s`` (the same coarse
outstanding-requests proxy ``BlendedRouter`` already ranks by); transfer
time as ``blocks x block_bytes / transfer_rate`` (EMA of client fetch
samples); prefill time as ``tokens / prefill_rate`` (EMA of engine chunk
samples, the engine's own ``_prefill_rate`` feed).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

ROUTE_WARM = "route_warm"
PULL = "pull"
COLD = "cold"


@dataclass
class TransferCostModelConfig:
    #: wire bytes per KV block (k+v pages; ``Engine.kv_block_bytes``)
    block_bytes: int
    block_size: int = 16
    #: modeled queue delay per outstanding request on a pod
    est_service_s: float = 0.05
    #: never pull chains shorter than this (per-fetch overhead floor)
    min_pull_blocks: int = 1
    #: cap on blocks one pull can actually move — set to the transfer
    #: plane's response cap (``TRANSFER_MAX_BLOCKS``) so the modeled pull
    #: matches the mechanism; None = uncapped fetches
    max_pull_blocks: Optional[int] = None


class TransferCostModel:
    def __init__(self, config: TransferCostModelConfig):
        if config.block_bytes < 1:
            raise ValueError("block_bytes must be >= 1")
        self.config = config
        self._mu = threading.Lock()
        self._transfer_rate: Optional[float] = None  # bytes/s  # guarded_by: _mu
        self._prefill_rate: Optional[float] = None  # tokens/s  # guarded_by: _mu

    # -- measured-rate feeds ------------------------------------------------
    @staticmethod
    def _ema(prev: Optional[float], sample: float, alpha: float = 0.3) -> float:
        return sample if prev is None else (1 - alpha) * prev + alpha * sample

    def observe_transfer(self, n_bytes: int, seconds: float) -> None:
        """Feed one measured fetch (``KVTransferClient.on_sample``)."""
        if n_bytes <= 0 or seconds <= 0:
            return
        with self._mu:
            self._transfer_rate = self._ema(self._transfer_rate, n_bytes / seconds)

    def observe_prefill(self, n_tokens: int, seconds: float) -> None:
        if n_tokens <= 0 or seconds <= 0:
            return
        with self._mu:
            self._prefill_rate = self._ema(self._prefill_rate, n_tokens / seconds)

    def seed_rates(
        self,
        transfer_bytes_s: Optional[float] = None,
        prefill_tokens_s: Optional[float] = None,
    ) -> None:
        """Pin rates directly — for callers that already measure them
        elsewhere (the engine's ``_prefill_rate`` EMA, a known link) and
        for deterministic tests/benchmarks. Non-positive values are
        ignored (same guard as ``observe_*``): a zero rate is "nothing
        measured", never a divisor."""
        with self._mu:
            if transfer_bytes_s is not None and transfer_bytes_s > 0:
                self._transfer_rate = transfer_bytes_s
            if prefill_tokens_s is not None and prefill_tokens_s > 0:
                self._prefill_rate = prefill_tokens_s

    @property
    def transfer_rate(self) -> Optional[float]:
        with self._mu:
            return self._transfer_rate

    @property
    def prefill_rate(self) -> Optional[float]:
        with self._mu:
            return self._prefill_rate

    # -- the decision -------------------------------------------------------
    def decide(
        self,
        prompt_len: int,
        warm_blocks: int,
        warm_load: float,
        cold_load: float,
    ) -> str:
        """Pick ``route_warm`` / ``pull`` / ``cold`` for one request.

        Abstains (``route_warm``) until BOTH rates are measured — the
        model must never un-warm routing on guesses, mirroring the host
        tier's bootstrap rule."""
        cfg = self.config
        with self._mu:
            tr, pr = self._transfer_rate, self._prefill_rate
        if tr is None or pr is None or warm_blocks < cfg.min_pull_blocks:
            return ROUTE_WARM
        # A pull can only move what the transfer plane will serve; the
        # warm pod itself still reuses its FULL prefix — the two arms see
        # different reusable lengths under the cap.
        pull_blocks = warm_blocks
        if cfg.max_pull_blocks is not None:
            pull_blocks = min(pull_blocks, cfg.max_pull_blocks)
        # The engine never serves an entire prompt from cache (one fresh
        # position is always computed), so cap the reusable prefix.
        warm_tokens = min(warm_blocks * cfg.block_size, max(prompt_len - 1, 0))
        pull_tokens = min(pull_blocks * cfg.block_size, max(prompt_len - 1, 0))
        q = cfg.est_service_s
        t_warm = warm_load * q + max(prompt_len - warm_tokens, 1) / pr
        t_pull = (
            cold_load * q
            + pull_blocks * cfg.block_bytes / tr
            + max(prompt_len - pull_tokens, 1) / pr
        )
        t_cold = cold_load * q + prompt_len / pr
        # Tie-break toward the least disruptive option: warm routing keeps
        # legacy behavior, pulling beats recomputing the same tokens.
        best, action = t_warm, ROUTE_WARM
        if t_pull < best:
            best, action = t_pull, PULL
        if t_cold < best:
            action = COLD
        return action

    def decide_remote(
        self,
        prompt_len: int,
        remote_blocks: int,
        target_load: float,
        warm_blocks: int = 0,
        warm_load: float = 0.0,
    ) -> str:
        """Remote-tier verdict: should the router pull ``remote_blocks``
        of this prompt's prefix from a remote holder (kvstore pod / peer
        remote store) onto the least-loaded serving pod?

        A remote hit must beat RECOMPUTE but lose to a warm LOCAL hit:
        ``pull`` is returned only when the modeled pull time undercuts
        BOTH serving at the warmest local pod (``warm_blocks`` there)
        and plain cold recompute on the target. The holder is storage,
        not compute, so "queue behind the warmth" is not an arm here.
        Abstains (``route_warm`` = let the legacy ranking stand) until
        both rates are measured, mirroring ``decide``'s bootstrap rule."""
        cfg = self.config
        with self._mu:
            tr, pr = self._transfer_rate, self._prefill_rate
        if tr is None or pr is None or remote_blocks < cfg.min_pull_blocks:
            return ROUTE_WARM
        pull_blocks = remote_blocks
        if cfg.max_pull_blocks is not None:
            pull_blocks = min(pull_blocks, cfg.max_pull_blocks)
        pull_tokens = min(pull_blocks * cfg.block_size, max(prompt_len - 1, 0))
        warm_tokens = min(warm_blocks * cfg.block_size, max(prompt_len - 1, 0))
        q = cfg.est_service_s
        t_pull = (
            target_load * q
            + pull_blocks * cfg.block_bytes / tr
            + max(prompt_len - pull_tokens, 1) / pr
        )
        t_cold = target_load * q + prompt_len / pr
        t_local = (
            warm_load * q + max(prompt_len - warm_tokens, 1) / pr
            if warm_blocks > 0
            else t_cold
        )
        return PULL if t_pull < min(t_local, t_cold) else ROUTE_WARM
