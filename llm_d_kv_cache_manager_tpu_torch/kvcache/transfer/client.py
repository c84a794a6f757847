"""Fetch side of the KV-transfer channel: DEALER with bounded timeouts.

A pull is strictly an optimization — every failure mode (dead peer, slow
link, truncated chain, garbage payload) must degrade to "recompute the
prefix cold", never wedge or crash the puller. So:

- every ``fetch`` polls with a hard deadline and raises ``TransferError``
  on expiry;
- after a timeout the socket is torn down and rebuilt, so a late straggler
  reply can never be mis-matched to the next request;
- successful fetches report ``(wire_bytes, seconds)`` to ``on_sample`` —
  the measured-link feed of the router's transfer-vs-recompute cost model;
- an optional per-peer **circuit breaker** (``breaker_failures > 0``) trips
  after consecutive failures, so a dead peer costs one timeout, not one
  timeout per request: while OPEN every fetch fails instantly (the caller's
  cold-prefill fallback runs with zero added latency) until an exponential
  backoff expires, then exactly one HALF_OPEN probe decides between CLOSED
  (recovered) and OPEN with doubled backoff.

Thread model: ``fetch`` is thread-safe but serializes per client — the
DEALER socket is single-request-in-flight by construction (a lock held
across send→recv is what makes the timeout/teardown story airtight).
``ASYNC_PULL`` workers therefore contend only when pulling from the SAME
peer (one client per endpoint in ``PodServer``); distinct peers fetch
fully in parallel. Sizing guidance in docs/operations.md.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ...utils import get_logger
from ..metrics import collector
from .protocol import (
    BlockPayload,
    MigrationPayload,
    decode_migrate_ack,
    decode_push_ack,
    decode_response,
    encode_migrate,
    encode_push,
    encode_request,
)

log = get_logger("kvcache.transfer.client")


class TransferError(RuntimeError):
    """A fetch failed (timeout, service error, undecodable reply)."""


@dataclass
class TransferClientConfig:
    endpoint: str = "tcp://localhost:5558"
    timeout_s: float = 10.0
    #: consecutive failures that trip the per-peer circuit breaker;
    #: 0 (default) disables the breaker — bit-identical legacy behavior.
    breaker_failures: int = 0
    #: first OPEN interval; doubles on each failed half-open probe.
    breaker_backoff_s: float = 1.0
    #: cap on the doubled backoff.
    breaker_backoff_max_s: float = 30.0


class CircuitBreaker:
    """Per-peer failure breaker: CLOSED → OPEN after ``failure_threshold``
    consecutive failures → HALF_OPEN (single probe) after backoff →
    CLOSED on probe success / OPEN (backoff doubled, capped) on failure.

    Thread-safe; ``clock`` is injectable for deterministic tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        failure_threshold: int,
        backoff_s: float = 1.0,
        backoff_max_s: float = 30.0,
        clock=time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.base_backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self._clock = clock
        self._mu = threading.Lock()
        self._state = self.CLOSED  # guarded_by: _mu
        self._failures = 0  # consecutive  # guarded_by: _mu
        self._backoff_s = backoff_s  # guarded_by: _mu
        self._opened_at = 0.0  # guarded_by: _mu
        self._probe_inflight = False  # guarded_by: _mu
        self.opens = 0  # guarded_by: _mu
        self.closes = 0  # guarded_by: _mu
        #: optional transition observer ``(state: "open"|"closed") -> None``
        #: (the OBS_FLIGHT recorder's breaker trigger); called OUTSIDE the
        #: lock, only on actual transitions. None (default) = legacy.
        self.on_transition = None

    @property
    def state(self) -> str:
        with self._mu:
            if self._state == self.OPEN and (
                self._clock() - self._opened_at >= self._backoff_s
            ):
                return self.HALF_OPEN  # next allow() admits the probe
            return self._state

    def allow(self) -> bool:
        """True when a request may proceed. While OPEN within backoff:
        False. After backoff: admits exactly ONE half-open probe; further
        calls are rejected until that probe reports."""
        with self._mu:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if self._state == self.OPEN:
                if now - self._opened_at < self._backoff_s:
                    return False
                self._state = self.HALF_OPEN
                self._probe_inflight = True
                return True
            # HALF_OPEN: one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._mu:
            recovered = self._state != self.CLOSED
            self._state = self.CLOSED
            self._failures = 0
            self._backoff_s = self.base_backoff_s
            self._probe_inflight = False
            if recovered:
                self.closes += 1
        if recovered:
            collector.bump("breaker_closes")
            collector.breaker_closes.inc()
            cb = self.on_transition
            if cb is not None:
                try:
                    cb("closed")
                except Exception:
                    log.exception("breaker on_transition callback failed")

    def record_failure(self) -> None:
        opened = False
        with self._mu:
            self._failures += 1
            if self._state == self.HALF_OPEN:
                # failed probe: reopen with doubled backoff
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._backoff_s = min(self._backoff_s * 2, self.backoff_max_s)
                self._probe_inflight = False
                self.opens += 1
                opened = True
            elif (
                self._state == self.CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._backoff_s = self.base_backoff_s
                self.opens += 1
                opened = True
        if opened:
            collector.bump("breaker_opens")
            collector.breaker_opens.inc()
            cb = self.on_transition
            if cb is not None:
                try:
                    cb("open")
                except Exception:
                    log.exception("breaker on_transition callback failed")

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "backoff_s": self._backoff_s,
                "opens": self.opens,
                "closes": self.closes,
            }


class KVTransferClient:
    def __init__(
        self,
        config: TransferClientConfig,
        on_sample: Optional[Callable[[int, float], None]] = None,
        breaker: Optional[CircuitBreaker] = None,
    ):
        self.config = config
        self.on_sample = on_sample
        self.breaker = breaker
        if self.breaker is None and config.breaker_failures > 0:
            self.breaker = CircuitBreaker(
                config.breaker_failures,
                config.breaker_backoff_s,
                config.breaker_backoff_max_s,
            )
        self.breaker_skips = 0  # fetches rejected instantly by an open breaker
        #: connection-reuse accounting: dials = sockets created (first use
        #: + post-timeout rebuilds), reuses = requests served on an
        #: already-connected DEALER. The saved dial time shows up directly
        #: in the ``kvcache_transfer_pull_seconds`` histogram — a reused
        #: socket's sample carries no connect/handshake share.
        self.dials = 0  # guarded_by: _mu
        self.reuses = 0  # guarded_by: _mu
        self._mu = threading.Lock()
        self._sock = None  # guarded_by: _mu
        self._closed = False  # guarded_by: _mu

    def _socket(self):  # kvlint: holds=_mu
        import zmq

        if self._sock is None:
            ctx = zmq.Context.instance()
            self._sock = ctx.socket(zmq.DEALER)
            # zmq connect is asynchronous (registers the endpoint with the
            # io thread; no handshake wait), so it cannot convoy the lock.
            self._sock.connect(self.config.endpoint)  # kvlint: disable=lock-discipline
            self.dials += 1
        else:
            self.reuses += 1
        return self._sock

    def _reset_socket(self) -> None:  # kvlint: holds=_mu
        if self._sock is not None:
            self._sock.close(linger=0)
            self._sock = None

    def fetch(
        self,
        model_name: str,
        block_hashes: Sequence[int],
        max_blocks: Optional[int] = None,
        timeout_s: Optional[float] = None,
        traceparent: Optional[str] = None,
    ) -> tuple[list[BlockPayload], bool]:
        """Fetch the longest resident prefix of ``block_hashes`` from the
        peer. Returns ``(blocks, complete)``; raises ``TransferError`` on
        timeout/service failure (callers fall back to cold prefill). With
        a tripped breaker the error is raised immediately — no socket I/O,
        no timeout wait. ``timeout_s`` overrides the configured poll
        deadline for this call — the hook request-deadline callers use to
        clamp a pull to the request's remaining budget. ``traceparent``
        (W3C) rides the request envelope so the exporting peer's spans
        join the puller's trace; None (default) keeps legacy wire bytes."""
        if not block_hashes:
            return [], True
        if self.breaker is not None and not self.breaker.allow():
            self.breaker_skips += 1
            raise TransferError(
                f"circuit open for {self.config.endpoint} "
                f"(skipping fetch; cold prefill)"
            )
        try:
            blocks, complete = self._fetch_once(
                model_name, block_hashes, max_blocks, timeout_s, traceparent
            )
        except Exception:
            # Any failure settles the breaker (a stuck half-open probe
            # would otherwise reject every later fetch forever).
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        if self.breaker is not None:
            self.breaker.record_success()
        return blocks, complete

    def push_blocks(
        self,
        model_name: str,
        source_pod: str,
        blocks: Sequence[BlockPayload],
        timeout_s: Optional[float] = None,
    ) -> tuple[int, int]:
        """Demotion push: ship ``blocks`` to the peer's remote store.
        Returns ``(accepted, headroom)`` from the ack; raises
        ``TransferError`` on timeout/refusal (the caller's fallback is
        plain eviction — the pages are simply gone, exactly the legacy
        outcome). Shares the fetch path's socket, lock, breaker, and
        teardown discipline, so a dead demotion target costs one timeout
        (then breaker-fast failures), never a wedged engine."""
        if not blocks:
            return 0, 0
        if self.breaker is not None and not self.breaker.allow():
            self.breaker_skips += 1
            raise TransferError(
                f"circuit open for {self.config.endpoint} "
                f"(skipping push; plain eviction)"
            )
        try:
            reply, dt = self._request_reply(
                encode_push(model_name, source_pod, list(blocks)),
                timeout_s,
                kind="push",
            )
        except Exception:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        decoded = decode_push_ack(reply)
        if decoded is None:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise TransferError("undecodable push ack")
        accepted, headroom, error = decoded
        if error is not None:
            # A refusal (legacy peer, store off, model mismatch) is a
            # protocol-level answer from a LIVE peer: settle the breaker
            # closed — fast-failing future pulls over a healthy link
            # because the peer declines pushes would be self-harm.
            if self.breaker is not None:
                self.breaker.record_success()
            raise TransferError(f"peer refused push: {error}")
        if self.breaker is not None:
            self.breaker.record_success()
        if self.on_sample is not None and accepted:
            self.on_sample(
                sum(b.wire_bytes for b in blocks[:accepted]), dt
            )
        return accepted, headroom

    def migrate(
        self,
        model_name: str,
        source_pod: str,
        migration: MigrationPayload,
        timeout_s: Optional[float] = None,
    ) -> tuple[int, bool]:
        """Live migration: ship one frozen in-flight decode sequence
        (state + KV chain) to the peer. Returns ``(accepted_blocks,
        resumed)`` from the ack; raises ``TransferError`` on
        timeout/refusal and returns ``resumed=False`` on a polite
        decline — either way the caller's fallback is resuming the
        sequence locally via cold recompute, exactly the no-migration
        outcome. Shares the fetch path's socket, lock, breaker, and
        teardown discipline."""
        if self.breaker is not None and not self.breaker.allow():
            self.breaker_skips += 1
            raise TransferError(
                f"circuit open for {self.config.endpoint} "
                f"(skipping migrate; local resume)"
            )
        try:
            reply, dt = self._request_reply(
                encode_migrate(model_name, source_pod, migration),
                timeout_s,
                kind="migrate",
            )
        except Exception:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        decoded = decode_migrate_ack(reply)
        if decoded is None:
            if self.breaker is not None:
                self.breaker.record_failure()
            raise TransferError("undecodable migrate ack")
        accepted, resumed, error = decoded
        if error is not None:
            # A refusal (legacy peer, controller off, model mismatch) is
            # a protocol-level answer from a LIVE peer: settle the
            # breaker closed, same reasoning as push refusals.
            if self.breaker is not None:
                self.breaker.record_success()
            raise TransferError(f"peer refused migrate: {error}")
        if self.breaker is not None:
            self.breaker.record_success()
        if self.on_sample is not None and accepted:
            self.on_sample(
                sum(b.wire_bytes for b in migration.blocks[:accepted]), dt
            )
        return accepted, resumed

    def _request_reply(
        self, payload: bytes, timeout_s: Optional[float], kind: str
    ) -> tuple[bytes, float]:
        """One send→recv cycle on the pooled DEALER with the hard-deadline
        poll and the teardown-on-timeout rule; returns (reply, seconds)."""
        import zmq

        deadline_s = self.config.timeout_s if timeout_s is None else timeout_s
        with self._mu:
            if self._closed:
                raise TransferError("client closed")
            sock = self._socket()
            t0 = time.perf_counter()
            try:
                sock.send(payload)
                if not sock.poll(int(deadline_s * 1000), zmq.POLLIN):
                    self._reset_socket()  # a late reply must not leak forward
                    raise TransferError(
                        f"{kind} timed out after {deadline_s}s "
                        f"({self.config.endpoint})"
                    )
                # Recv under _mu on purpose: ZMQ sockets are not thread-safe
                # and the reply must pair with its request (a second sender
                # interleaving on this DEALER would cross the streams).
                # Blocking is bounded by the poll() deadline above; fetch
                # concurrency comes from one client per pull worker.
                frames = sock.recv_multipart()  # kvlint: disable=lock-discipline
            except zmq.ZMQError as e:
                self._reset_socket()
                raise TransferError(f"{kind} failed: {e}") from e
            dt = time.perf_counter() - t0
        return frames[-1], dt

    def _fetch_once(
        self,
        model_name: str,
        block_hashes: Sequence[int],
        max_blocks: Optional[int],
        timeout_s: Optional[float] = None,
        traceparent: Optional[str] = None,
    ) -> tuple[list[BlockPayload], bool]:
        reply, dt = self._request_reply(
            encode_request(model_name, block_hashes, max_blocks, traceparent),
            timeout_s,
            kind="fetch",
        )
        decoded = decode_response(reply)
        if decoded is None:
            raise TransferError("undecodable transfer response")
        blocks, complete, error = decoded
        if error is not None:
            raise TransferError(f"peer refused fetch: {error}")
        if self.on_sample is not None and blocks:
            self.on_sample(sum(b.wire_bytes for b in blocks), dt)
        return blocks, complete

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            self._reset_socket()

    @property
    def closed(self) -> bool:
        with self._mu:
            return self._closed


class TransferClientPool:
    """Per-endpoint ``KVTransferClient`` pool: one long-lived DEALER per
    peer, shared by every caller that talks to that peer (``pull_prefix``,
    async-pull workers, demotion pushes), so repeat traffic to the same
    endpoint reuses the connected socket instead of re-dialing — the
    saved dial shows up directly in ``kvcache_transfer_pull_seconds``,
    and the per-client ``dials``/``reuses`` counters quantify it.

    Invalidation is breaker-aware: an OPEN breaker does NOT discard the
    client (the breaker state is precisely the knowledge worth keeping —
    a fresh client would pay a full timeout the breaker exists to skip);
    only a client someone ``close()``d is replaced on the next ``get``.

    ``config_factory(endpoint) -> TransferClientConfig`` supplies the
    per-peer config (timeouts, breaker thresholds); ``on_sample`` is the
    shared measured-link feed for the routing cost model.
    """

    def __init__(self, config_factory, on_sample=None):
        self._config_factory = config_factory
        self._on_sample = on_sample
        self._mu = threading.Lock()
        self._clients: dict[str, KVTransferClient] = {}  # guarded_by: _mu
        self._closed = False  # guarded_by: _mu

    def get(self, endpoint: str) -> Optional[KVTransferClient]:
        """The pooled client for ``endpoint`` (created on first use).
        None once the pool is closed — a client created after the
        shutdown sweep would leak its socket."""
        with self._mu:
            if self._closed:
                return None
            client = self._clients.get(endpoint)
            if client is None or client.closed:
                client = KVTransferClient(
                    self._config_factory(endpoint), on_sample=self._on_sample
                )
                self._clients[endpoint] = client
            return client

    def snapshot(self) -> dict:
        """Per-endpoint reuse/breaker accounting for ``/stats``."""
        with self._mu:
            clients = dict(self._clients)
        out = {}
        for ep, c in clients.items():
            with c._mu:
                dials, reuses = c.dials, c.reuses
            entry = {"dials": dials, "reuses": reuses}
            if c.breaker is not None:
                entry["breaker"] = c.breaker.snapshot()
            out[ep] = entry
        return out

    def clients(self) -> dict[str, KVTransferClient]:
        with self._mu:
            return dict(self._clients)

    def close_all(self) -> None:
        with self._mu:
            self._closed = True
            clients, self._clients = list(self._clients.values()), {}
        for client in clients:
            client.close()
