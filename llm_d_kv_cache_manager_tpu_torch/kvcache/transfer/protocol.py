"""KV-transfer wire format: msgpack-framed block-chain fetches.

Same framing discipline as the event plane (``kvevents/events.py``):
array-encoded tagged unions, positional and tolerant decoding (missing
trailing fields default, malformed messages decode to ``None`` rather than
raising — a poison request must never kill the export service).

- request: ``["FetchBlocks", model_name, [block_hash, ...], max_blocks,
  traceparent?]`` (the optional trailing W3C ``traceparent`` joins the
  exporting peer's spans to the puller's trace — appended ONLY when
  tracing is on, so default wire bytes are unchanged)
- response: ``["Blocks", complete, [[hash, parent_hash, token_ids,
  block_size, dtype, shape, k_data, v_data, quant?, k_scale?,
  v_scale?], ...]]`` (the optional trailing triple carries int8-KV
  compression — ``quant`` names the scheme, the scales are raw f32
  bytes of ``models/quant.kv_scale_shape``; appended ONLY when the
  exporter quantizes, so legacy wire bytes are unchanged and old
  importers, positional and tolerant, simply ignore it; a further
  optional trailing ``digest?`` — the KV_INTEGRITY write-time content
  checksum — rides after the triple, absent-triple positions filled
  with their decode defaults)
- error: ``["TransferError", message]``

Remote-tier demotion extension (``REMOTE_TIER``; never on the wire unless
a pod enables the knob, so default traffic is bit-identical and old
services answer an unknown tag with a tolerant ``TransferError`` the
pusher treats as "fall back to plain eviction"):

- push: ``["PushBlocks", model_name, source_pod, [block, ...]]`` — a pod
  about to destroy the last local copy of a chain ships the pages to a
  peer with headroom instead; block rows reuse the ``Blocks`` response
  encoding (including the optional trailing int8 quant triple, which
  halves demotion bytes exactly as it halves pull bytes).
- ack: ``["PushAck", accepted, headroom]`` — how many blocks the peer
  committed to its remote store, and how many more pages it will take
  (the pusher's per-peer headroom feed between heartbeats).

Live-migration extension (``FLEET_CONTROLLER``; never on the wire unless
the controller migrates a sequence, so default traffic is bit-identical
and old services answer the unknown tag with a tolerant ``TransferError``
the source treats as "fall back to local cold recompute"):

- migrate: ``["MigrateSeq", model_name, source_pod, request_id,
  token_ids, user_prompt_len, num_generated, [max_new_tokens,
  temperature, top_k, top_p, stop_token_ids], deadline_remaining_s,
  [block, ...]]`` — one frozen in-flight decode sequence: its full token
  history (the continuation prompt), generation bookkeeping, sampling
  state, remaining deadline budget, and the KV chain backing it (block
  rows reuse the ``Blocks`` encoding, quant triple included).
- ack: ``["MigrateAck", accepted, resumed]`` — how many chain blocks the
  target installed and whether it admitted the continuation; ``resumed``
  False means the source must resume the sequence locally.

Hashes are uint64 (the sha256-CBOR chain the whole system keys on); page
payloads ride as raw bytes of the engine's ``[n_layers, page_size,
n_kv_heads, head_dim]`` page slice, dtype/shape-tagged so the importer can
verify geometry before committing anything.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


FETCH_BLOCKS_TAG = "FetchBlocks"
BLOCKS_TAG = "Blocks"
ERROR_TAG = "TransferError"
PUSH_BLOCKS_TAG = "PushBlocks"
PUSH_ACK_TAG = "PushAck"
MIGRATE_SEQ_TAG = "MigrateSeq"
MIGRATE_ACK_TAG = "MigrateAck"


@dataclass
class BlockPayload:
    """One transferable KV block: chain identity + page bytes."""

    block_hash: int
    parent_block_hash: Optional[int]
    token_ids: list[int]
    block_size: int
    dtype: str
    #: per-page slice shape: (n_layers, page_size, n_kv_heads, head_dim)
    shape: tuple[int, ...]
    k_data: bytes
    v_data: bytes
    #: KV compression scheme ("int8") — None = full-width ``dtype`` bytes.
    #: ``dtype``/``shape`` stay the LOGICAL page geometry either way; with
    #: quant set, ``k_data``/``v_data`` are int8 bytes of that shape and
    #: the scales are raw f32 bytes of ``models/quant.kv_scale_shape``.
    quant: Optional[str] = None
    k_scale: bytes = b""
    v_scale: bytes = b""
    #: write-time content digest (``kvcache/integrity.page_digest`` over
    #: the payload bytes, KV_INTEGRITY) — None = sender does not attest.
    #: Rides as an optional trailing field, so knobs-off wire bytes are
    #: bit-identical and old importers simply ignore it.
    digest: Optional[int] = None

    @property
    def wire_bytes(self) -> int:
        return (
            len(self.k_data)
            + len(self.v_data)
            + len(self.k_scale)
            + len(self.v_scale)
        )


def encode_request(
    model_name: str,
    block_hashes: Sequence[int],
    max_blocks: Optional[int] = None,
    traceparent: Optional[str] = None,
) -> bytes:
    import msgpack

    arr: list = [
        FETCH_BLOCKS_TAG,
        model_name,
        [int(h) for h in block_hashes],
        max_blocks,
    ]
    if traceparent is not None:
        # Trailing optional field: only on the wire when tracing is on, so
        # the no-knobs request bytes stay bit-identical and old services
        # (positional, tolerant) simply ignore it.
        arr.append(traceparent)
    return msgpack.packb(arr, use_bin_type=True)


def decode_request(
    payload: bytes,
) -> Optional[tuple[str, list[int], Optional[int], Optional[str]]]:
    """``(model_name, block_hashes, max_blocks, traceparent)`` or None for
    garbage. ``traceparent`` is None when absent or non-string (tolerant:
    a malformed trace field must never fail the fetch)."""
    arr = _unpack(payload)
    if (
        not isinstance(arr, (list, tuple))
        or len(arr) < 3
        or _text(arr[0]) != FETCH_BLOCKS_TAG
        or not isinstance(arr[2], (list, tuple))
    ):
        return None
    model = _text(arr[1])
    if not isinstance(model, str) or not model:
        return None
    try:
        hashes = [int(h) for h in arr[2]]
    except (TypeError, ValueError):
        return None
    max_blocks = arr[3] if len(arr) > 3 else None
    if max_blocks is not None:
        try:
            max_blocks = int(max_blocks)
        except (TypeError, ValueError):
            return None
    traceparent = _text(arr[4]) if len(arr) > 4 else None
    if not isinstance(traceparent, str):
        traceparent = None
    return model, hashes, max_blocks, traceparent


def encode_block_row(b: BlockPayload) -> list:
    """One block's wire row — shared by the ``Blocks`` response and the
    ``PushBlocks`` demotion request so both sides of the fabric speak one
    block encoding (and the kvlint wire manifest pins it once)."""
    raw: list = [
        b.block_hash,
        b.parent_block_hash,
        list(b.token_ids),
        b.block_size,
        b.dtype,
        list(b.shape),
        b.k_data,
        b.v_data,
    ]
    if b.quant is not None:
        # Trailing optional triple: only on the wire for quantized
        # blocks, so unquantized response bytes stay bit-identical.
        raw.extend([b.quant, b.k_scale, b.v_scale])
    if b.digest is not None:
        if b.quant is None:
            # The digest rides at a fixed position past the quant triple;
            # fill the absent triple with its decode defaults (None
            # scheme + empty scales read exactly like no triple at all).
            raw.extend([None, b"", b""])
        raw.append(b.digest)
    return raw


def encode_response(blocks: Sequence[BlockPayload], complete: bool) -> bytes:
    import msgpack

    encoded = [encode_block_row(b) for b in blocks]
    return msgpack.packb(
        [BLOCKS_TAG, bool(complete), encoded], use_bin_type=True
    )


def encode_error(message: str) -> bytes:
    import msgpack

    return msgpack.packb([ERROR_TAG, message], use_bin_type=True)


def decode_response(
    payload: bytes,
) -> Optional[tuple[list[BlockPayload], bool, Optional[str]]]:
    """``(blocks, complete, error)``; ``error`` set for service-side
    failures, None return for undecodable payloads."""
    arr = _unpack(payload)
    if not isinstance(arr, (list, tuple)) or not arr:
        return None
    tag = _text(arr[0])
    if tag == ERROR_TAG:
        return [], False, _text(arr[1]) if len(arr) > 1 else "unknown error"
    if tag != BLOCKS_TAG or len(arr) < 3 or not isinstance(arr[2], (list, tuple)):
        return None
    blocks: list[BlockPayload] = []
    for raw in arr[2]:
        blk = _decode_block(raw)
        if blk is None:
            return None  # a half-garbled block corrupts the chain: reject all
        blocks.append(blk)
    return blocks, bool(arr[1]), None


def _decode_block(raw: Any) -> Optional[BlockPayload]:
    if not isinstance(raw, (list, tuple)) or len(raw) < 8:
        return None
    (h, parent, token_ids, block_size, dtype, shape, k_data, v_data) = raw[:8]
    if not isinstance(k_data, (bytes, bytearray)) or not isinstance(
        v_data, (bytes, bytearray)
    ):
        return None
    # Optional trailing quant triple (int8 KV): absent on legacy frames.
    quant = _text(raw[8]) if len(raw) > 8 else None
    if quant is not None and not isinstance(quant, str):
        return None  # a malformed scheme tag corrupts the payload meaning
    k_scale = raw[9] if len(raw) > 9 else b""
    v_scale = raw[10] if len(raw) > 10 else b""
    if not isinstance(k_scale, (bytes, bytearray)) or not isinstance(
        v_scale, (bytes, bytearray)
    ):
        return None
    # Optional trailing content digest (KV_INTEGRITY): absent on legacy
    # frames; a malformed digest decodes to None (unattested) — tolerant,
    # the importer falls back to the legacy trust model, never a crash.
    digest = raw[11] if len(raw) > 11 else None
    if digest is not None:
        try:
            digest = int(digest)
        except (TypeError, ValueError):
            digest = None
    try:
        return BlockPayload(
            block_hash=int(h),
            parent_block_hash=None if parent is None else int(parent),
            token_ids=[int(t) for t in (token_ids or [])],
            block_size=int(block_size),
            dtype=_text(dtype) or "",
            shape=tuple(int(d) for d in (shape or ())),
            k_data=bytes(k_data),
            v_data=bytes(v_data),
            quant=quant,
            k_scale=bytes(k_scale),
            v_scale=bytes(v_scale),
            digest=digest,
        )
    except (TypeError, ValueError):
        return None


def encode_push(
    model_name: str, source_pod: str, blocks: Sequence[BlockPayload]
) -> bytes:
    """Demotion push request: ship ``blocks`` to a peer's remote store."""
    import msgpack

    return msgpack.packb(
        [
            PUSH_BLOCKS_TAG,
            model_name,
            source_pod,
            [encode_block_row(b) for b in blocks],
        ],
        use_bin_type=True,
    )


def decode_push(
    payload: bytes,
) -> Optional[tuple[str, str, list[BlockPayload]]]:
    """``(model_name, source_pod, blocks)`` or None for non-push/garbage
    frames (the service tries ``decode_request`` first; a frame neither
    decoder accepts answers with a tolerant error, never a crash)."""
    arr = _unpack(payload)
    if (
        not isinstance(arr, (list, tuple))
        or len(arr) < 4
        or _text(arr[0]) != PUSH_BLOCKS_TAG
        or not isinstance(arr[3], (list, tuple))
    ):
        return None
    model = _text(arr[1])
    source = _text(arr[2])
    if not isinstance(model, str) or not model or not isinstance(source, str):
        return None
    blocks: list[BlockPayload] = []
    for raw in arr[3]:
        blk = _decode_block(raw)
        if blk is None:
            return None  # a half-garbled block corrupts the chain: reject all
        blocks.append(blk)
    return model, source, blocks


def encode_push_ack(accepted: int, headroom: int) -> bytes:
    import msgpack

    return msgpack.packb(
        [PUSH_ACK_TAG, int(accepted), int(headroom)], use_bin_type=True
    )


def decode_push_ack(
    payload: bytes,
) -> Optional[tuple[int, int, Optional[str]]]:
    """``(accepted, headroom, error)``; ``error`` set for service-side
    refusals (including legacy services that do not speak the push op),
    None return for undecodable payloads."""
    arr = _unpack(payload)
    if not isinstance(arr, (list, tuple)) or not arr:
        return None
    tag = _text(arr[0])
    if tag == ERROR_TAG:
        return 0, 0, _text(arr[1]) if len(arr) > 1 else "unknown error"
    if tag != PUSH_ACK_TAG or len(arr) < 3:
        return None
    try:
        return int(arr[1]), int(arr[2]), None
    except (TypeError, ValueError):
        return None


@dataclass
class MigrationPayload:
    """One in-flight decode sequence in transit: identity, decode state,
    and the KV chain backing it. ``token_ids`` is the FULL token history
    (prompt + generated so far) — on the target it becomes the
    continuation prompt, whose prefill cache-hits the imported chain, so
    greedy decode resumes from exactly the frozen context."""

    request_id: str
    token_ids: list[int]
    user_prompt_len: int
    num_generated: int
    #: frozen sampling state (the migrated sequence's "sampling key")
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    stop_token_ids: tuple[int, ...]
    #: seconds of request-deadline budget left at freeze; None = none set.
    deadline_remaining_s: Optional[float]
    blocks: list[BlockPayload] = field(default_factory=list)

    @property
    def wire_bytes(self) -> int:
        return sum(b.wire_bytes for b in self.blocks)


def encode_migrate(
    model_name: str, source_pod: str, m: MigrationPayload
) -> bytes:
    """Live-migration request: move one frozen decode sequence (state +
    KV chain) to the target pod, which resumes it mid-generation."""
    import msgpack

    arr: list = [
        MIGRATE_SEQ_TAG,
        model_name,
        source_pod,
        m.request_id,
        [int(t) for t in m.token_ids],
        int(m.user_prompt_len),
        int(m.num_generated),
        [
            int(m.max_new_tokens),
            float(m.temperature),
            int(m.top_k),
            float(m.top_p),
            [int(t) for t in m.stop_token_ids],
        ],
        m.deadline_remaining_s,
        [encode_block_row(b) for b in m.blocks],
    ]
    return msgpack.packb(arr, use_bin_type=True)


def decode_migrate(
    payload: bytes,
) -> Optional[tuple[str, str, MigrationPayload]]:
    """``(model_name, source_pod, migration)`` or None for
    non-migrate/garbage frames (tried after ``decode_request`` and
    ``decode_push``; a frame no decoder accepts answers with a tolerant
    error, never a crash)."""
    arr = _unpack(payload)
    if (
        not isinstance(arr, (list, tuple))
        or len(arr) < 10
        or _text(arr[0]) != MIGRATE_SEQ_TAG
        or not isinstance(arr[4], (list, tuple))
        or not isinstance(arr[7], (list, tuple))
        or len(arr[7]) < 5
        or not isinstance(arr[9], (list, tuple))
    ):
        return None
    model = _text(arr[1])
    source = _text(arr[2])
    request_id = _text(arr[3])
    if (
        not isinstance(model, str)
        or not model
        or not isinstance(source, str)
        or not isinstance(request_id, str)
        or not request_id
    ):
        return None
    samp = arr[7]
    try:
        token_ids = [int(t) for t in arr[4]]
        user_prompt_len = int(arr[5])
        num_generated = int(arr[6])
        max_new_tokens = int(samp[0])
        temperature = float(samp[1])
        top_k = int(samp[2])
        top_p = float(samp[3])
        stop_token_ids = tuple(int(t) for t in (samp[4] or ()))
    except (TypeError, ValueError):
        return None
    deadline_remaining_s = arr[8]
    if deadline_remaining_s is not None:
        try:
            deadline_remaining_s = float(deadline_remaining_s)
        except (TypeError, ValueError):
            return None
    blocks: list[BlockPayload] = []
    for raw in arr[9]:
        blk = _decode_block(raw)
        if blk is None:
            return None  # a half-garbled block corrupts the chain: reject all
        blocks.append(blk)
    return (
        model,
        source,
        MigrationPayload(
            request_id=request_id,
            token_ids=token_ids,
            user_prompt_len=user_prompt_len,
            num_generated=num_generated,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            stop_token_ids=stop_token_ids,
            deadline_remaining_s=deadline_remaining_s,
            blocks=blocks,
        ),
    )


def encode_migrate_ack(accepted: int, resumed: bool) -> bytes:
    import msgpack

    return msgpack.packb(
        [MIGRATE_ACK_TAG, int(accepted), bool(resumed)], use_bin_type=True
    )


def decode_migrate_ack(
    payload: bytes,
) -> Optional[tuple[int, bool, Optional[str]]]:
    """``(accepted, resumed, error)``; ``error`` set for service-side
    refusals (including legacy services that do not speak the migrate
    op), None return for undecodable payloads."""
    arr = _unpack(payload)
    if not isinstance(arr, (list, tuple)) or not arr:
        return None
    tag = _text(arr[0])
    if tag == ERROR_TAG:
        return 0, False, _text(arr[1]) if len(arr) > 1 else "unknown error"
    if tag != MIGRATE_ACK_TAG or len(arr) < 3:
        return None
    try:
        return int(arr[1]), bool(arr[2]), None
    except (TypeError, ValueError):
        return None


def _unpack(payload: bytes) -> Any:
    import msgpack

    try:
        return msgpack.unpackb(payload, raw=False)
    except Exception:
        return None


def _text(v: Any) -> Any:
    if isinstance(v, (bytes, bytearray)):
        return v.decode("utf-8", "replace")
    return v
