"""Page export service: ZMQ ROUTER answering block-chain fetches.

Each pod binds one ROUTER socket (``TRANSFER_ENDPOINT``); peer pods connect
DEALERs and request prefix chains by block hash. Transport idioms follow
``kvevents/zmq_subscriber.py``: the stable side binds, poll with a short
timeout so shutdown stays responsive, reconnect forever with backoff on
socket errors, and never let a malformed request kill the loop.

The service itself owns no KV state — the ``handler`` callback
(``(block_hashes, max_blocks) -> list[BlockPayload]``) is supplied by the
pod server, which bridges onto the engine loop thread (the only thread
allowed to touch page pools). Responses are length-capped twice: at
``max_blocks`` (request cap is clamped to the service's own) and at
``max_reply_bytes`` of page payload, so one fetch can never wedge the
socket with an unbounded chain.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ...utils import get_logger
from .protocol import (
    BlockPayload,
    MigrationPayload,
    decode_migrate,
    decode_push,
    decode_request,
    encode_error,
    encode_migrate_ack,
    encode_push_ack,
    encode_response,
)

log = get_logger("kvcache.transfer.service")

_POLL_TIMEOUT_MS = 250
_RECONNECT_BACKOFF_S = 5.0


@dataclass
class TransferServiceConfig:
    endpoint: str = "tcp://*:5558"
    model_name: str = "unknown-model"
    #: hard cap on blocks per response (requests may ask for fewer)
    max_blocks: int = 64
    #: hard cap on page-payload bytes per response
    max_reply_bytes: int = 256 << 20


class KVTransferService:
    """Binds a ROUTER socket and serves prefix-chain fetches."""

    def __init__(
        self,
        config: TransferServiceConfig,
        handler: Callable[[list[int], int], Sequence[BlockPayload]],
        tracer=None,
        push_handler: Optional[
            Callable[[str, list[BlockPayload]], tuple[int, int]]
        ] = None,
        migrate_handler: Optional[
            Callable[[str, MigrationPayload], tuple[int, bool]]
        ] = None,
    ):
        """``tracer`` (an ``obs.Tracer``, optional): when tracing is on,
        each served fetch records a ``transfer.export`` span, parented on
        the ``traceparent`` the puller carried in the request envelope —
        the exporting peer's time joins the pulling request's trace.
        ``push_handler`` (``(source_pod, blocks) -> (accepted, headroom)``,
        optional): accepts remote-tier demotion pushes into this pod's
        remote store. None (default, ``REMOTE_TIER`` off) answers pushes
        with a tolerant error the pusher treats as "fall back to plain
        eviction" — exactly what a legacy service does.
        ``migrate_handler`` (``(source_pod, migration) -> (accepted,
        resumed)``, optional): accepts live-migrated in-flight decode
        sequences. None (default, ``FLEET_CONTROLLER`` off) answers
        migrations with a tolerant error the source treats as "resume the
        sequence locally" — again exactly the legacy answer."""
        self.config = config
        self.handler = handler
        self.tracer = tracer
        self.push_handler = push_handler
        self.migrate_handler = migrate_handler
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: observability, read by /stats
        self.requests_served = 0
        self.blocks_served = 0
        self.pushes_served = 0
        self.blocks_pushed = 0
        self.migrations_served = 0
        self.migration_blocks_accepted = 0

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="kv-transfer-service", daemon=True
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
                self._serve(ctx)
            except Exception:
                log.exception(
                    "transfer service failed; rebinding",
                    backoff_s=_RECONNECT_BACKOFF_S,
                )
                if self._stop.wait(_RECONNECT_BACKOFF_S):
                    return

    def _serve(self, ctx) -> None:
        import zmq

        sock = ctx.socket(zmq.ROUTER)
        try:
            sock.bind(self.config.endpoint)
            log.info(
                "kv transfer service listening",
                endpoint=self.config.endpoint,
                max_blocks=self.config.max_blocks,
            )
            poller = zmq.Poller()
            poller.register(sock, zmq.POLLIN)
            while not self._stop.is_set():
                if not dict(poller.poll(_POLL_TIMEOUT_MS)):
                    continue
                frames = sock.recv_multipart()
                if len(frames) < 2:
                    log.debug("dropping short transfer request", n=len(frames))
                    continue
                ident, payload = frames[0], frames[-1]
                sock.send_multipart([ident, self._handle(payload)])
        finally:
            sock.close(linger=0)

    def _handle(self, payload: bytes) -> bytes:
        req = decode_request(payload)
        if req is None:
            push = decode_push(payload)
            if push is not None:
                return self._handle_push(*push)
            migrate = decode_migrate(payload)
            if migrate is not None:
                return self._handle_migrate(*migrate)
            return encode_error("malformed request")
        model, hashes, max_blocks, traceparent = req
        span = None
        if self.tracer is not None and self.tracer.enabled:
            from ...obs.tracing import parse_traceparent

            span = self.tracer.start_span(
                "transfer.export",
                parent=parse_traceparent(traceparent),
                attrs={"model": model, "requested_blocks": len(hashes)},
            )
        try:
            if model != self.config.model_name:
                return encode_error(
                    f"model mismatch: serving {self.config.model_name!r}"
                )
            cap = self.config.max_blocks
            if max_blocks is not None and max_blocks > 0:
                cap = min(cap, max_blocks)
            try:
                blocks = list(self.handler(hashes[:cap], cap))
            except Exception as e:
                log.exception("transfer handler failed")
                if span is not None:
                    span.set_attr("error", type(e).__name__)
                return encode_error(f"export failed: {type(e).__name__}")
            blocks, complete = self._cap_bytes(blocks, len(hashes))
            self.requests_served += 1
            self.blocks_served += len(blocks)
            if span is not None:
                span.set_attr("served_blocks", len(blocks))
                span.set_attr(
                    "wire_bytes", sum(b.wire_bytes for b in blocks)
                )
            return encode_response(blocks, complete)
        finally:
            if span is not None:
                span.end()

    def _handle_push(
        self, model: str, source_pod: str, blocks: list[BlockPayload]
    ) -> bytes:
        """Remote-tier demotion push: commit the blocks via the pod's
        ``push_handler`` and ack (accepted, headroom). Refusals are plain
        protocol errors — the pusher's fallback is the eviction it was
        about to do anyway, so nothing here may raise."""
        if self.push_handler is None:
            return encode_error("push unsupported (REMOTE_TIER off)")
        if model != self.config.model_name:
            return encode_error(
                f"model mismatch: serving {self.config.model_name!r}"
            )
        try:
            accepted, headroom = self.push_handler(
                source_pod, blocks[: self.config.max_blocks]
            )
        except Exception as e:
            log.exception("push handler failed")
            return encode_error(f"push failed: {type(e).__name__}")
        self.pushes_served += 1
        self.blocks_pushed += accepted
        return encode_push_ack(accepted, headroom)

    def _handle_migrate(
        self, model: str, source_pod: str, migration: MigrationPayload
    ) -> bytes:
        """Live sequence migration: install the chain and admit the
        continuation via the pod's ``migrate_handler``, ack ``(accepted,
        resumed)``. Refusals are plain protocol errors — the source's
        fallback is resuming the sequence locally (cold recompute), so
        nothing here may raise."""
        if self.migrate_handler is None:
            return encode_error("migrate unsupported (FLEET_CONTROLLER off)")
        if model != self.config.model_name:
            return encode_error(
                f"model mismatch: serving {self.config.model_name!r}"
            )
        try:
            accepted, resumed = self.migrate_handler(source_pod, migration)
        except Exception as e:
            log.exception("migrate handler failed")
            return encode_error(f"migrate failed: {type(e).__name__}")
        self.migrations_served += 1
        self.migration_blocks_accepted += accepted
        return encode_migrate_ack(accepted, resumed)

    def _cap_bytes(
        self, blocks: list[BlockPayload], n_requested: int
    ) -> tuple[list[BlockPayload], bool]:
        total = 0
        for i, blk in enumerate(blocks):
            total += blk.wire_bytes
            if total > self.config.max_reply_bytes and i > 0:
                # Truncate, never drop block 0: a response must always make
                # progress or the client would retry the same oversize ask.
                return blocks[:i], False
        return blocks, len(blocks) >= n_requested
