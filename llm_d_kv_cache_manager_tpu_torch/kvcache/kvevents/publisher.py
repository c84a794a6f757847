"""ZMQ PUB publisher for KV events.

Counterpart of the subscriber: used by the in-tree JAX serving engine's
block manager to announce block stores/evictions, and by demos/tests to
simulate a fleet (reference ``examples/kv_events/offline/publisher.go``).
Publishers **connect** to the subscriber's bound endpoint; each message is
3 frames ``[topic, seq (8B big-endian), msgpack payload]`` with a
monotonically increasing per-publisher sequence number.
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ...utils import get_logger
from .events import Event, EventBatch

log = get_logger("kvcache.kvevents.publisher")


@dataclass
class ZMQPublisherConfig:
    endpoint: str = "tcp://localhost:5557"
    pod_identifier: str = "local-pod"
    model_name: str = "unknown-model"
    # Rank of this publisher in a data-parallel fleet, tagged onto batches.
    data_parallel_rank: Optional[int] = None


#: bounded send retries: the index tolerates lost batches (LRU staleness
#: model), so after these attempts the batch is DROPPED — a transient
#: socket error must never raise into the engine loop and kill serving.
_SEND_ATTEMPTS = 3
_SEND_BACKOFF_S = 0.05


class ZMQPublisher:
    def __init__(self, config: ZMQPublisherConfig):
        import zmq

        self.config = config
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.PUB)
        self._sock.connect(config.endpoint)
        self._mu = threading.Lock()
        self._seq = 0  # guarded_by: _mu
        self._closed = False  # guarded_by: _mu
        self.dropped_batches = 0  # guarded_by: _mu
        self.topic = f"kv@{config.pod_identifier}@{config.model_name}"

    def publish(self, events: list[Event], ts: Optional[float] = None) -> int:
        """Publish one EventBatch; returns the sequence number used (-1
        when the publisher is closed or the batch was dropped after
        bounded retries — the subscriber's seq gaps flag the loss)."""
        import zmq

        batch = EventBatch(
            # Wall clock on purpose: ts crosses the wire, compared across hosts.
            ts=ts if ts is not None else time.time(),  # kvlint: disable=monotonic-time
            events=events,
            data_parallel_rank=self.config.data_parallel_rank,
        )
        payload = batch.to_payload()
        with self._mu:
            if self._closed:
                log.warning("publish after close; dropping batch")
                self.dropped_batches += 1
                return -1
            # The seq is consumed HERE, before any send attempt: a dropped
            # batch therefore leaves a hole in the stream and the next
            # successful publish exposes it — subscribers detect the gap
            # and trigger resync instead of silently desyncing.
            seq = self._seq
            self._seq += 1
            frames = [self.topic.encode("utf-8"), struct.pack(">Q", seq), payload]
            # Send/backoff UNDER _mu on purpose: PUB sockets are not
            # thread-safe, and releasing the lock mid-retry would let a
            # later seq overtake this one on the wire — subscribers would
            # read the reorder as a gap and trigger spurious resyncs.
            # Worst case is ~0.15s (bounded retries); publish is called
            # off the engine's hot path.
            for attempt in range(_SEND_ATTEMPTS):
                try:
                    self._sock.send_multipart(frames)  # kvlint: disable=lock-discipline
                    return seq
                except zmq.ZMQError as e:
                    if attempt + 1 == _SEND_ATTEMPTS:
                        # Give up: the engine loop must keep serving; the
                        # dropped-batch counter rides on heartbeats and the
                        # skipped seq flags the gap to subscribers.
                        self.dropped_batches += 1
                        log.warning(
                            "dropping event batch after bounded retries",
                            pod=self.config.pod_identifier,
                            model=self.config.model_name,
                            error=repr(e),
                            attempts=_SEND_ATTEMPTS,
                            seq=seq,
                            dropped_total=self.dropped_batches,
                        )
                        return -1
                    time.sleep(_SEND_BACKOFF_S * (2**attempt))  # kvlint: disable=lock-discipline
        return -1  # unreachable; keeps the contract explicit

    def close(self) -> None:
        """Idempotent: double-close must not hit an already-closed socket."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            self._sock.close(linger=100)
