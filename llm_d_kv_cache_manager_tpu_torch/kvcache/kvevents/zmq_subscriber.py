"""ZMQ SUB transport for KV events.

Parity with reference ``pkg/kvcache/kvevents/zmq_subscriber.go``: the
subscriber **binds** and serving-engine publishers connect (``:90``) — one
indexer endpoint, many TPU server replicas. Contract:

- endpoint default ``tcp://*:5557``, topic filter default ``kv@``;
- topic format ``kv@<pod>@<model>`` (``:136-144``); model names may
  themselves contain ``@``? No — pod may not, model takes the remainder;
- 3-frame messages ``[topic, seq (8B big-endian), payload]`` (``:124-132``);
- poll with a short timeout so shutdown is responsive (``:33,112``);
- on socket errors, reconnect forever with 5s backoff (``:31,67-75``).
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass
from typing import Optional

from ...utils import get_logger
from .pool import KVEventsPool, Message

log = get_logger("kvcache.kvevents.zmq")

DEFAULT_ENDPOINT = "tcp://*:5557"
DEFAULT_TOPIC_FILTER = "kv@"
_POLL_TIMEOUT_MS = 250
_RECONNECT_BACKOFF_S = 5.0


@dataclass
class ZMQSubscriberConfig:
    endpoint: str = DEFAULT_ENDPOINT
    topic_filter: str = DEFAULT_TOPIC_FILTER


def parse_topic(topic: str) -> Optional[tuple[str, str]]:
    """``kv@<pod>@<model>`` → (pod, model); model keeps any further ``@``s."""
    parts = topic.split("@", 2)
    if len(parts) != 3 or not parts[1] or not parts[2]:
        return None
    return parts[1], parts[2]


class ZMQSubscriber:
    """Feeds a KVEventsPool from a bound SUB socket.

    Frame hardening: the SUB socket receives raw network input, so every
    malformed shape — wrong frame count, short/overlong seq frame,
    undecodable or unparseable topic — is counted in ``malformed_dropped``
    and dropped; nothing a peer sends can kill the receive loop.
    """

    def __init__(self, pool: KVEventsPool, config: Optional[ZMQSubscriberConfig] = None):
        self.pool = pool
        self.config = config or ZMQSubscriberConfig()
        #: drop counters by malformed shape (surfaced in /stats)
        self.malformed_dropped = {"frames": 0, "seq": 0, "topic": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="kvevents-zmq-subscriber", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- internals ----------------------------------------------------------
    def _run(self) -> None:
        import zmq

        ctx = zmq.Context.instance()
        while not self._stop.is_set():
            try:
                self._run_subscriber(ctx)
            except Exception:
                log.exception(
                    "zmq subscriber failed; reconnecting",
                    backoff_s=_RECONNECT_BACKOFF_S,
                )
                if self._stop.wait(_RECONNECT_BACKOFF_S):
                    return

    def _run_subscriber(self, ctx) -> None:
        import zmq

        sock = ctx.socket(zmq.SUB)
        try:
            sock.bind(self.config.endpoint)  # SUB binds; publishers connect
            sock.setsockopt_string(zmq.SUBSCRIBE, self.config.topic_filter)
            log.info(
                "zmq subscriber listening",
                endpoint=self.config.endpoint,
                topic=self.config.topic_filter,
            )
            poller = zmq.Poller()
            poller.register(sock, zmq.POLLIN)
            while not self._stop.is_set():
                if not dict(poller.poll(_POLL_TIMEOUT_MS)):
                    continue
                frames = sock.recv_multipart()
                try:
                    msg = self._parse_frames(frames)
                except Exception:
                    # Belt-and-braces: a parse bug must not tear down the
                    # receive loop into a reconnect storm.
                    log.exception("frame parse failed; dropping message")
                    continue
                if msg is not None:
                    self.pool.add_task(msg)
        finally:
            sock.close(linger=0)

    def _parse_frames(self, frames: list[bytes]) -> Optional[Message]:
        if len(frames) != 3:
            self.malformed_dropped["frames"] += 1
            log.warning("dropping malformed zmq message", n_frames=len(frames))
            return None
        topic_raw, seq_raw, payload = frames
        if len(seq_raw) != 8:
            # A wrong-width seq frame means the peer speaks a different
            # protocol; guessing seq=0 would poison gap detection.
            self.malformed_dropped["seq"] += 1
            log.warning("dropping message with bad seq frame", n_bytes=len(seq_raw))
            return None
        try:
            topic = topic_raw.decode("utf-8")
        except UnicodeDecodeError:
            self.malformed_dropped["topic"] += 1
            log.warning("dropping message with undecodable topic")
            return None
        parsed = parse_topic(topic)
        if parsed is None:
            self.malformed_dropped["topic"] += 1
            log.warning("dropping message with unparseable topic", topic=topic)
            return None
        pod, model = parsed
        seq = struct.unpack(">Q", seq_raw)[0]
        return Message(topic=topic, pod_identifier=pod, model_name=model, payload=payload, seq=seq)
