"""KV-event schema: msgpack tagged-union wire format.

Parity with reference ``pkg/kvcache/kvevents/events.go``: events travel as
msgpack *array-encoded* structs matching the serving engine's publisher —

- ``EventBatch``: ``[ts, [event, ...], data_parallel_rank?]``
- ``BlockStored``: ``["BlockStored", block_hashes, parent_block_hash,
  token_ids, block_size, lora_id?, medium?]``
- ``BlockRemoved``: ``["BlockRemoved", block_hashes, medium?]``
- ``AllBlocksCleared``: ``["AllBlocksCleared"]``

Self-healing extensions (only on the wire when a pod enables the
heartbeat/resync knobs, so the default wire traffic is bit-identical and
old subscribers simply skip the unknown tags):

- ``Heartbeat``: ``["Heartbeat", dropped_batches?, draining?]`` — liveness
  beacon; ``dropped_batches`` is the publisher's monotone count of batches
  dropped after bounded send retries, so the indexer can detect loss even
  when no later seq reveals the gap (e.g. the dropped batch was the last
  before idle). ``draining`` advertises a pod mid-drain so the
  scorer stops routing to it before the final goodbye; it is only encoded
  when true, so heartbeat bytes from a non-draining pod are unchanged.
- ``IndexSnapshot``: ``["IndexSnapshot", {medium: [block_hashes]}]`` — a
  compact digest of every block the pod currently holds, per tier. The
  ingestion pool applies it as replace-all-for-pod, the reconciliation
  primitive behind sequence-gap repair.
- ``PodDrained``: ``["PodDrained"]`` — a graceful goodbye: the pod
  finished draining and its cache is about to vanish. The ingestion pool
  evicts the pod from the index immediately (no ``POD_TTL_S`` wait) and
  ``FleetHealth`` marks it drained so the scorer never routes to it.

Disaggregated serving extensions (on the wire only when
``POD_ROLE`` is set, so default traffic stays bit-identical):

- ``Heartbeat`` grows a trailing ``role`` field (``"prefill"`` /
  ``"decode"``; ``mixed``, the default, is never encoded) so the scorer
  can keep prefill-only pods out of decode placement and vice versa.
  The ``draining`` position is filled (with ``False`` when needed) only
  when a role follows it — a role-less, non-draining heartbeat's bytes
  are unchanged.
- ``PrefillComplete``: ``["PrefillComplete", request_id, num_blocks]`` —
  a prefill-role pod finished a request's ingest (stopped at the first
  token) and the prompt's block chain is registered and exportable over
  the transfer fabric. The handoff itself rides the serving plane; this
  event lets the fleet (and the bench/chaos harnesses) observe handoff
  supply without polling pods, and proves liveness like any message.

Remote-tier extension (on the wire only when a pod sets
``REMOTE_TIER``, so default traffic stays bit-identical):

- ``Heartbeat`` grows a trailing ``headroom`` field — how many more
  demoted pages the pod's remote store will accept. The role position
  before it is filled with the explicit ``"mixed"`` sentinel when the pod
  has no role (decodes back to None); pods may also advertise the new
  ``kvstore`` role, a dedicated holder the scorer excludes from every
  serving placement. ``BlockStored``/``BlockRemoved`` reuse their
  existing ``medium`` field with ``"remote"`` — published by the HOLDER
  pod, so index eviction on pod death drops exactly the entries whose
  bytes actually died.

Routing-quality observability extension (on the wire only when
a pod sets ``OBS_AUDIT``, so default traffic stays bit-identical):

- ``RequestAudit``: ``["RequestAudit", request_id, realized_blocks]`` —
  the serving pod's ground truth for one finished request: how many
  prompt blocks its prefix cache actually served. The indexer-side
  ``RouteAuditor`` joins it with the decision's predicted matched-block
  count into the predicted-vs-realized ratio, regret and miss-attribution
  metrics. Observation-only on the index.

KV-integrity extension (on the wire only when a pod sets
``KV_INTEGRITY`` *and* detects a corrupt page, so default traffic stays
bit-identical):

- ``BadBlock``: ``["BadBlock", block_hashes, pod?, medium?]`` — fleet-wide
  revocation of a quarantined block: a content-digest check failed, the
  copy is poison, and every scorer must drop the index entry for the
  HOLDER pod (``pod``; ``""``, the default, means the publisher itself —
  an importer that catches a peer's corrupt export names the exporter).
  ``medium`` narrows the revocation to one tier; None drops every tier.
  Peers holding replica copies purge them on receipt.

Decoding is positional and tolerant: trailing optional fields may be absent
(the reference's "legacy" variants, ``events.go:113-153``) and unknown extra
fields are ignored — this subsumes the reference's arity-sniffing legacy
dispatch (``pool.go:308-317``) without duplicating event types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Union


BLOCK_STORED_TAG = "BlockStored"
BLOCK_REMOVED_TAG = "BlockRemoved"
ALL_BLOCKS_CLEARED_TAG = "AllBlocksCleared"
HEARTBEAT_TAG = "Heartbeat"
INDEX_SNAPSHOT_TAG = "IndexSnapshot"
POD_DRAINED_TAG = "PodDrained"
PREFILL_COMPLETE_TAG = "PrefillComplete"
REQUEST_AUDIT_TAG = "RequestAudit"
BAD_BLOCK_TAG = "BadBlock"

#: roles a pod may advertise (anything else decodes to None = mixed).
#: ``kvstore`` (remote tier) marks a dedicated KV-store pod:
#: it holds demoted blocks and serves transfer pulls but never serves
#: requests — the scorer keeps it out of EVERY placement.
POD_ROLES = ("prefill", "decode", "mixed", "kvstore")


@dataclass
class BlockStored:
    block_hashes: list[int]
    parent_block_hash: Optional[int] = None
    token_ids: list[int] = field(default_factory=list)
    block_size: int = 0
    lora_id: Optional[int] = None
    medium: Optional[str] = None

    def to_tagged_union(self) -> list[Any]:
        return [
            BLOCK_STORED_TAG,
            self.block_hashes,
            self.parent_block_hash,
            self.token_ids,
            self.block_size,
            self.lora_id,
            self.medium,
        ]


@dataclass
class BlockRemoved:
    block_hashes: list[int]
    medium: Optional[str] = None

    def to_tagged_union(self) -> list[Any]:
        return [BLOCK_REMOVED_TAG, self.block_hashes, self.medium]


@dataclass
class AllBlocksCleared:
    def to_tagged_union(self) -> list[Any]:
        return [ALL_BLOCKS_CLEARED_TAG]


@dataclass
class Heartbeat:
    #: publisher's monotone dropped-batch count (bounded-retry overflow)
    dropped_batches: int = 0
    #: pod is mid-drain: stop routing to it (encoded only when true so a
    #: non-draining heartbeat's wire bytes are identical to previous rounds)
    draining: bool = False
    #: advertised serving role ("prefill"/"decode"/"kvstore"; None =
    #: mixed, the default, never encoded). Drives the scorer's placement
    #: filter and the two-hop planner's tier split. Trailing-append: the
    #: draining position before it is filled only when a role follows, so
    #: role-less heartbeat bytes stay bit-identical legacy.
    role: Optional[str] = None
    #: remote-tier headroom advertisement: how many more
    #: demoted pages this pod's remote store will accept. None (the
    #: default, ``REMOTE_TIER`` off) is never encoded — headroom-less
    #: heartbeat bytes stay bit-identical legacy. Trailing-append: when
    #: present, the draining/role positions before it are filled (role
    #: with the explicit "mixed" sentinel, which decodes back to None).
    headroom: Optional[int] = None

    def to_tagged_union(self) -> list[Any]:
        arr: list[Any] = [HEARTBEAT_TAG, self.dropped_batches]
        if self.draining or self.role is not None or self.headroom is not None:
            arr.append(bool(self.draining))
        if self.role is not None:
            arr.append(self.role)
        elif self.headroom is not None:
            # Positional filler so headroom lands in its own slot; "mixed"
            # is the explicit spelling of role-None and decodes back to it.
            arr.append("mixed")
        if self.headroom is not None:
            arr.append(int(self.headroom))
        return arr


@dataclass
class IndexSnapshot:
    """Digest of every block a pod currently holds, keyed by medium string
    (``tpu_hbm``/``host_dram``). Applied as replace-all-for-pod."""

    blocks_by_medium: dict[str, list[int]] = field(default_factory=dict)

    def to_tagged_union(self) -> list[Any]:
        return [INDEX_SNAPSHOT_TAG, self.blocks_by_medium]


@dataclass
class PodDrained:
    """Graceful goodbye: the pod drained and its cache is gone — evict it
    from the index now rather than waiting out ``POD_TTL_S``."""

    def to_tagged_union(self) -> list[Any]:
        return [POD_DRAINED_TAG]


@dataclass
class PrefillComplete:
    """A prefill-role pod finished a request's ingest: the prompt's block
    chain is registered locally and exportable over the transfer fabric.
    Observation-only on the index (the chain's ``BlockStored`` events are
    the locality truth); ``FleetHealth`` counts it as handoff supply and
    as liveness. Published only by role-enabled pods — absent from all
    default wire traffic."""

    request_id: str = ""
    #: full prompt pages registered for the chain (export upper bound)
    num_blocks: int = 0

    def to_tagged_union(self) -> list[Any]:
        return [PREFILL_COMPLETE_TAG, self.request_id, self.num_blocks]


@dataclass
class RequestAudit:
    """The serving pod's realized prefix-cache hit count for one finished
    request — the ground-truth half of the routing audit (the scorer-side
    ``RouteAuditor`` holds the predicted half, keyed by request id).
    Observation-only on the index; published only by ``OBS_AUDIT`` pods —
    absent from all default wire traffic."""

    request_id: str = ""
    #: prompt blocks served from this pod's prefix cache at first prefill
    realized_blocks: int = 0

    def to_tagged_union(self) -> list[Any]:
        return [REQUEST_AUDIT_TAG, self.request_id, self.realized_blocks]


@dataclass
class BadBlock:
    """Fleet-wide revocation of quarantined blocks (KV_INTEGRITY): a
    content-digest check failed, so the named copies are poison. The
    scorer drops the holder's index entries (every tier unless ``medium``
    narrows it) and peers purge replica copies. Published under the
    detector's topic but attributed to the HOLDER identity: ``pod`` names
    whose bytes are bad (``""`` = the publisher itself — the spelling a
    pod uses for its own host/HBM tiers; an importer that catches a
    peer's corrupt export names the exporter). Quarantine marks the bad
    *copy*, never the token identity — a later ``BlockStored`` for the
    same hash (fresh recompute) re-registers normally."""

    block_hashes: list[int]
    #: holder identity ("" = the publishing pod itself)
    pod: str = ""
    #: tier of the bad copy ("tpu_hbm"/"host_dram"/"remote"); None = all
    medium: Optional[str] = None

    def to_tagged_union(self) -> list[Any]:
        arr: list[Any] = [BAD_BLOCK_TAG, self.block_hashes]
        if self.pod or self.medium is not None:
            arr.append(self.pod)
        if self.medium is not None:
            arr.append(self.medium)
        return arr


Event = Union[
    BlockStored,
    BlockRemoved,
    AllBlocksCleared,
    Heartbeat,
    IndexSnapshot,
    PodDrained,
    PrefillComplete,
    RequestAudit,
    BadBlock,
]


@dataclass
class EventBatch:
    ts: float
    events: list[Event]
    data_parallel_rank: Optional[int] = None

    def to_payload(self) -> bytes:
        """Serialize to the wire format (array-encoded, like the engine)."""
        import msgpack

        arr = [self.ts, [e.to_tagged_union() for e in self.events]]
        if self.data_parallel_rank is not None:
            arr.append(self.data_parallel_rank)
        return msgpack.packb(arr, use_bin_type=True, default=_coerce_numpy)


def _coerce_numpy(obj):
    """msgpack default hook: numpy scalars → python ints/floats."""
    if hasattr(obj, "item"):
        return obj.item()
    raise TypeError(f"cannot serialize {type(obj)!r}")


def _get(parts: Sequence, idx: int, default=None):
    return parts[idx] if idx < len(parts) else default


def _decode_event(raw) -> Optional[Event]:
    """Decode one tagged-union event; None for malformed/unknown events."""
    import msgpack

    if isinstance(raw, (bytes, bytearray)):
        raw = msgpack.unpackb(raw, raw=False)
    if not isinstance(raw, (list, tuple)) or not raw:
        return None
    tag = raw[0]
    if isinstance(tag, bytes):
        tag = tag.decode("utf-8", "replace")
    fields = raw[1:]
    if tag == BLOCK_STORED_TAG:
        hashes = _get(fields, 0)
        if not isinstance(hashes, (list, tuple)):
            return None
        medium = _get(fields, 5)
        if isinstance(medium, bytes):
            medium = medium.decode("utf-8", "replace")
        return BlockStored(
            block_hashes=[int(h) for h in hashes],
            parent_block_hash=_get(fields, 1),
            token_ids=list(_get(fields, 2) or []),
            block_size=int(_get(fields, 3) or 0),
            lora_id=_get(fields, 4),
            medium=medium,
        )
    if tag == BLOCK_REMOVED_TAG:
        hashes = _get(fields, 0)
        if not isinstance(hashes, (list, tuple)):
            return None
        medium = _get(fields, 1)
        if isinstance(medium, bytes):
            medium = medium.decode("utf-8", "replace")
        return BlockRemoved(block_hashes=[int(h) for h in hashes], medium=medium)
    if tag == ALL_BLOCKS_CLEARED_TAG:
        return AllBlocksCleared()
    if tag == HEARTBEAT_TAG:
        dropped = _get(fields, 0, 0)
        if not isinstance(dropped, int) or isinstance(dropped, bool):
            dropped = 0
        draining = _get(fields, 1, False)
        if not isinstance(draining, bool):
            draining = False
        role = _get(fields, 2)
        if isinstance(role, bytes):
            role = role.decode("utf-8", "replace")
        if role not in POD_ROLES:
            role = None  # tolerant: an unknown role never breaks liveness
        if role == "mixed":
            # The explicit filler a headroom-carrying mixed pod encodes;
            # no legacy encoder ever emits it (role-None is simply absent).
            role = None
        headroom = _get(fields, 3)
        if not isinstance(headroom, int) or isinstance(headroom, bool):
            headroom = None  # tolerant: bad headroom never breaks liveness
        return Heartbeat(
            dropped_batches=dropped,
            draining=draining,
            role=role,
            headroom=headroom,
        )
    if tag == INDEX_SNAPSHOT_TAG:
        raw_digest = _get(fields, 0)
        if not isinstance(raw_digest, dict):
            return None
        digest: dict[str, list[int]] = {}
        for medium, hashes in raw_digest.items():
            if isinstance(medium, bytes):
                medium = medium.decode("utf-8", "replace")
            if not isinstance(medium, str) or not isinstance(hashes, (list, tuple)):
                return None
            digest[medium] = [int(h) for h in hashes]
        return IndexSnapshot(blocks_by_medium=digest)
    if tag == POD_DRAINED_TAG:
        return PodDrained()
    if tag == PREFILL_COMPLETE_TAG:
        rid = _get(fields, 0, "")
        if isinstance(rid, bytes):
            rid = rid.decode("utf-8", "replace")
        if not isinstance(rid, str):
            rid = ""
        n = _get(fields, 1, 0)
        if not isinstance(n, int) or isinstance(n, bool):
            n = 0
        return PrefillComplete(request_id=rid, num_blocks=n)
    if tag == REQUEST_AUDIT_TAG:
        rid = _get(fields, 0, "")
        if isinstance(rid, bytes):
            rid = rid.decode("utf-8", "replace")
        if not isinstance(rid, str):
            rid = ""
        n = _get(fields, 1, 0)
        if not isinstance(n, int) or isinstance(n, bool):
            n = 0
        return RequestAudit(request_id=rid, realized_blocks=n)
    if tag == BAD_BLOCK_TAG:
        hashes = _get(fields, 0)
        if not isinstance(hashes, (list, tuple)):
            return None
        pod = _get(fields, 1, "")
        if isinstance(pod, bytes):
            pod = pod.decode("utf-8", "replace")
        if not isinstance(pod, str):
            pod = ""  # tolerant: a bad holder field means "the publisher"
        medium = _get(fields, 2)
        if isinstance(medium, bytes):
            medium = medium.decode("utf-8", "replace")
        if medium is not None and not isinstance(medium, str):
            medium = None  # tolerant: a bad medium widens to every tier
        return BadBlock(
            block_hashes=[int(h) for h in hashes], pod=pod, medium=medium
        )
    return None  # unknown tag


def decode_event_batch(payload: bytes) -> Optional[EventBatch]:
    """Decode a wire payload; returns None for poison pills (undecodable).

    Malformed/unknown events inside an otherwise-valid batch are skipped,
    mirroring the reference's per-event tolerance (``pool.go:183-243``).
    """
    import msgpack

    try:
        arr = msgpack.unpackb(payload, raw=False)
    except Exception:
        return None
    if not isinstance(arr, (list, tuple)) or len(arr) < 2:
        return None
    ts, raw_events = arr[0], arr[1]
    if not isinstance(raw_events, (list, tuple)) or not isinstance(ts, (int, float)):
        return None
    events = []
    for raw in raw_events:
        try:
            ev = _decode_event(raw)
        except Exception:
            ev = None
        if ev is not None:
            events.append(ev)
    dp_rank = arr[2] if len(arr) > 2 else None
    return EventBatch(ts=float(ts), events=events, data_parallel_rank=dp_rank)
