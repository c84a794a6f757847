"""Event-ingestion worker pool: sharded, per-pod ordered.

Parity with reference ``pkg/kvcache/kvevents/pool.go``: incoming messages
are sharded by FNV-1a(pod id) onto per-worker FIFO queues so events for one
pod are always applied in order (``pool.go:125-137``); workers decode the
msgpack batch and apply Add/Evict to the block index. Poison pills are
dropped, not retried (``:174-180``).

TPU retarget: the pod entry tier comes from the event's ``medium`` field
({tpu_hbm, host_dram}) rather than the reference's hardcoded ``"gpu"``
(``pool.go:247``).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Optional

from ...utils import RateLimitedWarn, get_logger
from ..kvblock import DeviceTier, Index, Key, PodEntry, tier_for_medium
from .events import (
    AllBlocksCleared,
    BadBlock,
    BlockRemoved,
    BlockStored,
    Heartbeat,
    IndexSnapshot,
    PodDrained,
    PrefillComplete,
    RequestAudit,
    decode_event_batch,
)

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # avoids a runtime import cycle with health.py
    from .health import FleetHealth

log = get_logger("kvcache.kvevents.pool")
#: index-backend faults repeat at the event rate when a backend degrades;
#: warn with a suppressed-repeat count instead of one line per event.
_warn = RateLimitedWarn(log)

DEFAULT_CONCURRENCY = 4


def fnv1a_32(data: bytes) -> int:
    """FNV-1a 32-bit (matches Go ``hash/fnv.New32a``)."""
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


@dataclass
class Message:
    """One raw event message from the transport
    (reference ``zmq_subscriber.go`` Message)."""

    topic: str
    pod_identifier: str
    model_name: str
    payload: bytes
    seq: int = 0


@dataclass
class KVEventsPoolConfig:
    concurrency: int = DEFAULT_CONCURRENCY
    # Transport config is attached by the subscriber layer (zmq_subscriber).


class KVEventsPool:
    """Sharded ordered worker pool applying KV events to the index.

    ``health`` (optional, a ``FleetHealth``) receives per-message stream
    observations — last-seen seq per (pod, model) for gap detection,
    heartbeats, resync acknowledgements. ``staleness`` (optional, an
    ``obs.StalenessTracker``) records publish→apply lag per (pod, event
    type) plus received/applied seq high-waters; ``audit`` (optional, an
    ``obs.RouteAuditor``) receives ``RequestAudit`` realized-hit reports;
    ``lifecycle`` (optional, an ``obs.lifecycle.BlockLifecycleLedger``)
    receives the per-pod ``BlockStored``/``BlockRemoved`` tier story —
    the scorer-side half of the OBS_LIFECYCLE ledger, derived from the
    stream this pool already decodes (no new wire fields);
    ``on_bad_block`` (optional, ``fn(holder, block_hashes, medium)``)
    fires after a ``BadBlock`` revocation lands on the index — serving
    layers hook replica purges (remote-store copies of the revoked
    block) here. All ``None`` (default) keeps the legacy behavior
    bit-identical.
    """

    def __init__(
        self,
        index: Index,
        config: Optional[KVEventsPoolConfig] = None,
        health: Optional["FleetHealth"] = None,
        *,
        staleness=None,
        audit=None,
        lifecycle=None,
        on_bad_block=None,
    ):
        self.config = config or KVEventsPoolConfig()
        if self.config.concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        self.index = index
        self.health = health
        self.staleness = staleness
        self.audit = audit
        self.lifecycle = lifecycle
        self.on_bad_block = on_bad_block
        self._mu = threading.Lock()
        #: tasks rejected because the pool was already shut down — after the
        #: poison pill a task would sit unprocessed forever, which is worse
        #: than an honest drop (the index self-heals via resync anyway).
        self.rejected_after_shutdown = 0  # guarded_by: _mu
        #: immutable after construction; workers index it lock-free
        self._queues: list["queue.Queue[Optional[Message]]"] = [
            queue.Queue() for _ in range(self.config.concurrency)
        ]
        self._threads: list[threading.Thread] = []  # guarded_by: _mu
        self._running = False  # guarded_by: _mu
        self._started = False  # guarded_by: _mu

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        with self._mu:
            if self._running:
                return
            self._running = True
            self._started = True
            for i in range(self.config.concurrency):
                t = threading.Thread(
                    target=self._worker, args=(i,), name=f"kvevents-worker-{i}", daemon=True
                )
                t.start()
                self._threads.append(t)

    def shutdown(self) -> None:
        """Idempotent. Drain ordering: the poison pill is enqueued BEHIND
        any already-queued events, so every event accepted before shutdown
        is applied to the index before the workers join."""
        with self._mu:
            if not self._running:
                return
            self._running = False
            for q in self._queues:
                q.put(None)
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=5)

    def drain(self, timeout: float = 5.0) -> bool:
        """Block until all queued *and in-flight* events have been applied."""
        import time

        # Deadline math on the monotonic clock: a wall-clock (time.time)
        # deadline steps under NTP slew and can wait forever or not at all.
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(q.unfinished_tasks == 0 for q in self._queues):
                return True
            time.sleep(0.002)
        return False

    # -- ingestion ----------------------------------------------------------
    def add_task(self, msg: Message) -> None:
        """Shard by pod id so per-pod ordering holds. Tasks offered after
        shutdown are rejected (counted), never silently parked behind the
        poison pill — the check and the enqueue share the pool lock, so a
        racing shutdown cannot slip its pill under an admitted task."""
        shard = fnv1a_32(msg.pod_identifier.encode("utf-8")) % self.config.concurrency
        with self._mu:
            if self._started and not self._running:
                self.rejected_after_shutdown += 1
            else:
                self._queues[shard].put(msg)
                if self.staleness is not None:
                    # Received high-water BEFORE the worker applies it: the
                    # delta to the applied high-water is the events-behind
                    # gauge (only admitted tasks count — a rejected task
                    # will never be applied, so counting it would pin the
                    # gauge above zero forever).
                    self.staleness.observe_received(msg.pod_identifier, msg.seq)
                return
        log.warning("event after pool shutdown; dropping", pod=msg.pod_identifier)

    def _worker(self, shard: int) -> None:
        q = self._queues[shard]
        while True:
            msg = q.get()
            if msg is None:
                q.task_done()
                return
            try:
                self._process_event(msg)
            except Exception:
                # Deliberately broad: ANY failure on one message must not
                # kill the worker thread — a dead shard silently stops
                # applying its pods' events forever. Rate-limited so a
                # poison storm stays one WARN per interval, not one per
                # message (reference pool.go:174-180).
                _warn.warning(
                    f"worker-{shard}",
                    "failed to process event message; dropping",
                    exc_info=True,
                    pod=msg.pod_identifier,
                )
            finally:
                q.task_done()

    def _process_event(self, msg: Message) -> None:
        batch = decode_event_batch(msg.payload)
        if batch is None:
            log.debug("failed to unmarshal event batch, dropping message", topic=msg.topic)
            return

        # Stream-integrity observation BEFORE applying: per-pod ordering is
        # guaranteed by sharding, so last-seen seq per (pod, model) is
        # exact; a skip marks the pod's view suspect until a resync.
        if self.health is not None:
            self.health.observe_message(msg.pod_identifier, msg.model_name, msg.seq)

        for ev in batch.events:
            if isinstance(ev, BlockStored):
                keys = [Key(msg.model_name, h) for h in ev.block_hashes]
                entries = [PodEntry(msg.pod_identifier, tier_for_medium(ev.medium))]
                try:
                    self.index.add(keys, entries)
                except Exception:
                    # Backend-specific fault zoo (redis I/O, native index,
                    # lru) — broad by necessity, loud by rate-limited WARN.
                    _warn.warning(
                        "index-add",
                        "failed to add event to index",
                        exc_info=True,
                        pod=msg.pod_identifier,
                    )
                if self.lifecycle is not None:
                    self.lifecycle.observe_stored(
                        msg.pod_identifier, ev.block_hashes, ev.medium
                    )
            elif isinstance(ev, BlockRemoved):
                if ev.medium is None:
                    # No medium (incl. legacy events) = the pod no longer
                    # holds the block at all: clear every tier, else an entry
                    # stored with an explicit medium would never match the
                    # eviction and stale locality would persist forever.
                    entries = [PodEntry(msg.pod_identifier, t) for t in DeviceTier]
                else:
                    entries = [PodEntry(msg.pod_identifier, tier_for_medium(ev.medium))]
                for h in ev.block_hashes:
                    try:
                        self.index.evict(Key(msg.model_name, h), entries)
                    except Exception:
                        _warn.warning(
                            "index-evict",
                            "failed to evict from index",
                            exc_info=True,
                            pod=msg.pod_identifier,
                        )
                if self.lifecycle is not None:
                    self.lifecycle.observe_removed(
                        msg.pod_identifier, ev.block_hashes, ev.medium
                    )
            elif isinstance(ev, BadBlock):
                # Fleet-wide revocation: a pod's digest check caught a
                # corrupt copy. The HOLDER (``ev.pod`` when the detector
                # published under its own identity on a peer's behalf,
                # else the publisher itself) loses its index entry NOW —
                # the scorer must stop routing toward poisoned warmth —
                # and replica purges fan out via ``on_bad_block``.
                holder = ev.pod or msg.pod_identifier
                if ev.medium is None:
                    entries = [PodEntry(holder, t) for t in DeviceTier]
                else:
                    entries = [PodEntry(holder, tier_for_medium(ev.medium))]
                for h in ev.block_hashes:
                    try:
                        self.index.evict(Key(msg.model_name, h), entries)
                    except Exception:
                        _warn.warning(
                            "bad-block-evict",
                            "failed to revoke bad block from index",
                            exc_info=True,
                            pod=holder,
                        )
                if self.audit is not None:
                    # Routes already in flight toward the revoked entry
                    # will miss: attribute those as ``quarantined``.
                    self.audit.observe_bad_block(ev.block_hashes)
                if self.health is not None:
                    self.health.observe_bad_block(
                        holder, len(ev.block_hashes)
                    )
                from ..metrics import collector

                collector.observe_bad_blocks(len(ev.block_hashes))
                if self.on_bad_block is not None:
                    try:
                        self.on_bad_block(holder, ev.block_hashes, ev.medium)
                    except Exception:
                        _warn.warning(
                            "bad-block-purge",
                            "bad-block purge callback failed",
                            exc_info=True,
                            pod=holder,
                        )
            elif isinstance(ev, Heartbeat):
                if self.health is not None:
                    self.health.observe_heartbeat(
                        msg.pod_identifier,
                        ev.dropped_batches,
                        ev.draining,
                        role=ev.role,
                        headroom=ev.headroom,
                    )
            elif isinstance(ev, PrefillComplete):
                # Observation-only: the chain's BlockStored events already
                # carry the locality truth; this just counts handoff supply
                # (and liveness, via observe_message above).
                if self.health is not None:
                    self.health.observe_prefill_complete(msg.pod_identifier)
            elif isinstance(ev, IndexSnapshot):
                self._apply_snapshot(msg, ev)
            elif isinstance(ev, PodDrained):
                # Graceful goodbye: evict the pod NOW — a drained pod's
                # cache is gone and a rolling restart must not serve stale
                # locality for a whole POD_TTL_S. Eviction is unconditional
                # (no health needed): the pod itself declared the state.
                try:
                    self.index.evict_pod(msg.pod_identifier)
                except Exception:
                    _warn.warning(
                        "evict-pod",
                        "drained-pod eviction failed",
                        exc_info=True,
                        pod=msg.pod_identifier,
                    )
                if self.health is not None:
                    self.health.observe_drained(msg.pod_identifier)
                if self.lifecycle is not None:
                    # The ledger must not keep a drained pod's blocks
                    # "resident" forever — end every tracked residency.
                    self.lifecycle.observe_pod_gone(
                        msg.pod_identifier, "drained"
                    )
                log.info(
                    "pod drained; evicted from index", pod=msg.pod_identifier
                )
            elif isinstance(ev, RequestAudit):
                # Observation-only: the pod's realized prefix-cache hit
                # count joins the scorer's prediction in the route auditor
                # (predicted-vs-realized ratio + miss attribution).
                if self.audit is not None:
                    self.audit.record_realized(
                        ev.request_id, msg.pod_identifier, ev.realized_blocks
                    )
            elif isinstance(ev, AllBlocksCleared):
                # No-op, as in the reference (pool.go:300-301): the event
                # carries no hash list, and the index ages entries out.
                continue

        if self.staleness is not None:
            # AFTER the apply loop: the lag measured is publish → index
            # VISIBILITY (what a routing decision at this instant would
            # see), not publish → dequeue.
            self.staleness.observe_batch(
                msg.pod_identifier,
                msg.seq,
                batch.ts,
                [type(ev).__name__ for ev in batch.events],
            )

    def _apply_snapshot(self, msg: Message, ev: IndexSnapshot) -> None:
        """Replace-all-for-pod reconciliation: the digest IS the pod's KV
        cache, so first drop every entry the index holds for the pod, then
        add exactly the digest. Runs on the pod's own shard worker, so it
        is ordered against the pod's normal event stream.

        Contract: a pod identifier serves ONE model (the in-tree PodServer
        invariant — one engine, one topic ``kv@<pod>@<model>``; the digest
        covers that engine's whole cache). ``evict_pod`` sweeps all models,
        so a pod identity shared by publishers of different models would
        have its other models' entries wiped here — give each engine its
        own pod identifier instead."""
        try:
            self.index.evict_pod(msg.pod_identifier)
        except Exception:
            _warn.warning(
                "resync-evict",
                "resync: evict_pod failed",
                exc_info=True,
                pod=msg.pod_identifier,
            )
            return
        if self.lifecycle is not None:
            # Replace-all means replace-all in the ledger too: end every
            # tracked residency, then re-open exactly the digest's.
            self.lifecycle.observe_pod_gone(msg.pod_identifier, "resync")
        for medium, hashes in ev.blocks_by_medium.items():
            if not hashes:
                continue
            keys = [Key(msg.model_name, h) for h in hashes]
            entries = [PodEntry(msg.pod_identifier, tier_for_medium(medium))]
            try:
                self.index.add(keys, entries)
            except Exception:
                _warn.warning(
                    "resync-add",
                    "resync: failed to apply snapshot tier",
                    exc_info=True,
                    pod=msg.pod_identifier,
                    medium=medium,
                )
            if self.lifecycle is not None:
                self.lifecycle.observe_stored(
                    msg.pod_identifier, hashes, medium
                )
        if self.health is not None:
            self.health.observe_resync(msg.pod_identifier)
        log.info(
            "applied index snapshot (replace-all-for-pod)",
            pod=msg.pod_identifier,
            blocks={m: len(h) for m, h in ev.blocks_by_medium.items()},
        )
