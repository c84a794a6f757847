"""Remote KV-block store: the third rung of the capacity ladder.

``{tpu_hbm, host_dram}`` grew a ``remote`` tier (SURVEY §2.3's "and later
remote"): when local pressure would destroy the LAST copy of a chain, the
owning pod demotes the pages over the transfer fabric to a peer with
headroom — or a dedicated ``POD_ROLE=kvstore`` pod — and this store is
what the receiving side keeps. Blocks are held **wire-ready** (the exact
``BlockPayload`` the push carried, int8 triple and all): serving a
pull-back is a dict walk plus the ZMQ send, no page pool, no device, no
requantization round trip.

The holder publishes ``BlockStored(medium="remote")`` under its OWN pod
identity when it accepts a push (and ``BlockRemoved(medium="remote")``
when capacity LRU-drops a block), so index entries for demoted chains are
keyed to the *holder* — the pod whose death actually loses the bytes.
``evict_pod``/``PodDrained`` semantics then need no special casing: the
holder dying drops exactly its remote entries, the demoter dying drops
nothing it no longer holds.

Validation mirrors the import path's trust model: geometry (page size,
logical shape, dtype, payload byte lengths — including the int8 scale
triple's exact size) and the chain-hash self-consistency check
(``hash_block(parent, token_ids) == block_hash``), so a tampered or
truncated push registers nothing. The KV bytes themselves are covered by
the payload's carried content digest when the KV_INTEGRITY plane is
attached: a push whose bytes fail their own digest is rejected, and a
stored block that rots is caught at serve time — quarantined, removed,
and revoked fleet-wide via ``BadBlock`` — before any importer installs
it. Unattested payloads (legacy senders) keep the legacy trust model:
verifying without a digest would be the recompute demotion exists to
avoid.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ...utils import RateLimitedWarn, get_logger
from ..kvblock.token_processor import hash_block
from .protocol import BlockPayload

log = get_logger("kvcache.transfer.remote_store")
_warn = RateLimitedWarn(log)


@dataclass
class RemoteStoreConfig:
    #: capacity in pages (blocks); 0 = the store accepts nothing
    capacity_pages: int
    #: tokens per page — pushed blocks must match exactly
    page_size: int
    #: logical page slice shape (n_layers, page_size, n_kv_heads, head_dim)
    page_shape: tuple[int, ...]
    #: numpy dtype string of the LOGICAL page ("bfloat16"/"float32"/...)
    dtype: str
    #: raw f32 bytes of one page's quant-scale tensor (int8 triple check)
    scale_bytes: int
    #: root of the sha256-CBOR chain (``ChunkedTokenDatabase.init_hash``)
    init_hash: int


class RemoteBlockStore:
    """LRU store of demoted KV blocks, keyed by chain hash.

    Single-threaded by contract: lives on the engine loop (the pod's
    push/export staging already serializes there) or a bench arm's
    driver. ``on_events`` receives ``BlockStored``/``BlockRemoved``
    events with ``medium="remote"`` — the holder's locality truth.
    """

    def __init__(
        self,
        config: RemoteStoreConfig,
        on_events: Optional[Callable[[list], None]] = None,
        integrity=None,
    ):
        if config.capacity_pages < 0:
            raise ValueError("capacity_pages must be >= 0")
        self.config = config
        self.on_events = on_events
        #: KV_INTEGRITY plane (a ``BlockIntegrity``), or None = legacy
        #: trust model. The store never uses the side TABLE — a stored
        #: payload carries its own digest (``BlockPayload.digest``), so a
        #: block that is simultaneously host-resident here under a
        #: different representation cannot collide; the instance only
        #: feeds the shared check/quarantine accounting.
        self.integrity = integrity
        self._blocks: "OrderedDict[int, BlockPayload]" = OrderedDict()
        import numpy as np

        self._page_bytes = int(np.prod(config.page_shape)) * np.dtype(
            config.dtype
        ).itemsize
        self._q_page_bytes = int(np.prod(config.page_shape))
        #: monotone counters (surface via /stats "remote" block)
        self.stats = {
            "accepted": 0,
            "rejected": 0,
            "evicted": 0,
            "served": 0,
        }
        if integrity is not None:
            # Extra keys only when the knob is on: the knobs-off /stats
            # payload (which embeds this dict) stays bit-identical.
            self.stats["digest_rejected"] = 0
            self.stats["quarantined"] = 0

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, h: int) -> bool:
        return h in self._blocks

    @property
    def headroom(self) -> int:
        return max(self.config.capacity_pages - len(self._blocks), 0)

    def hashes(self) -> list[int]:
        """Every resident chain hash — the ``remote`` medium of the
        holder's ``IndexSnapshot`` digest, so a resync never wipes the
        demoted entries it is supposed to protect."""
        return list(self._blocks.keys())

    def _valid(self, blk: BlockPayload) -> bool:
        cfg = self.config
        if (
            blk.block_size != cfg.page_size
            or tuple(blk.shape) != tuple(cfg.page_shape)
            or blk.dtype != cfg.dtype
            or len(blk.token_ids) != cfg.page_size
        ):
            return False
        if blk.quant is not None:
            if (
                blk.quant != "int8"
                or len(blk.k_data) != self._q_page_bytes
                or len(blk.v_data) != self._q_page_bytes
                or len(blk.k_scale) != cfg.scale_bytes
                or len(blk.v_scale) != cfg.scale_bytes
            ):
                return False
        elif (
            len(blk.k_data) != self._page_bytes
            or len(blk.v_data) != self._page_bytes
        ):
            return False
        # Chain-hash self-consistency: the hash the whole system keys on
        # must be derivable from the tokens the payload claims — a
        # tampered token list or forged hash never registers.
        parent = (
            blk.parent_block_hash
            if blk.parent_block_hash is not None
            else cfg.init_hash
        )
        return hash_block(parent, blk.token_ids) == blk.block_hash

    def accept(
        self, blocks: Sequence[BlockPayload], source_pod: str = ""
    ) -> int:
        """Commit pushed blocks; returns how many registered. Invalid
        blocks are rejected individually (unlike the import path there is
        no chain-continuity requirement — a store may hold mid-chain runs
        whose parents live elsewhere in the fleet; the pull-back walk is
        what enforces consecutiveness). Over capacity the LRU block is
        dropped, with its ``BlockRemoved(remote)`` goodbye.

        ``source_pod`` (the pusher) contextualizes reject warnings; a
        storm of rejects from one peer logs rate-limited, never one line
        per block."""
        if self.config.capacity_pages == 0:
            return 0
        from ..kvevents.events import BlockRemoved, BlockStored

        accepted = 0
        events: list = []
        for blk in blocks:
            if blk.block_hash in self._blocks:
                self._blocks.move_to_end(blk.block_hash)
                continue
            if not self._valid(blk):
                self.stats["rejected"] += 1
                _warn.warning(
                    "accept-reject",
                    "pushed KV block rejected (geometry/chain-hash)",
                    pod=source_pod or "<unknown>",
                    block=blk.block_hash,
                )
                continue
            if self.integrity is not None:
                from ..integrity import CHECK_CORRUPT, page_digest

                computed = page_digest(
                    blk.k_data, blk.v_data, blk.k_scale, blk.v_scale
                )
                if (
                    self.integrity.check_carried(
                        blk.block_hash, blk.digest, computed, "remote_accept"
                    )
                    == CHECK_CORRUPT
                ):
                    # Bytes rotted in flight: refuse to register — the
                    # block never becomes servable, so no BadBlock (there
                    # is no index entry to revoke, and the pusher's local
                    # copy is already gone either way).
                    self.stats["rejected"] += 1
                    self.stats["digest_rejected"] += 1
                    _warn.warning(
                        "accept-digest",
                        "pushed KV block failed content digest; rejected",
                        pod=source_pod or "<unknown>",
                        block=blk.block_hash,
                    )
                    continue
            while len(self._blocks) >= self.config.capacity_pages:
                old_h, _ = self._blocks.popitem(last=False)
                self.stats["evicted"] += 1
                events.append(
                    BlockRemoved(block_hashes=[old_h], medium="remote")
                )
            self._blocks[blk.block_hash] = blk
            accepted += 1
            self.stats["accepted"] += 1
            events.append(
                BlockStored(
                    block_hashes=[blk.block_hash],
                    parent_block_hash=blk.parent_block_hash,
                    token_ids=list(blk.token_ids),
                    block_size=blk.block_size,
                    medium="remote",
                )
            )
        if events and self.on_events is not None:
            self.on_events(events)
        return accepted

    def serve(
        self, hashes: Sequence[int], max_blocks: Optional[int] = None
    ) -> list[BlockPayload]:
        """Pull-back read path: the longest consecutive resident run of
        ``hashes`` (the same stop-at-first-gap rule as
        ``BlockManager.lookup_chain`` — a block behind a gap can never
        prefix-hit on the importer). Touches served blocks to MRU."""
        out: list[BlockPayload] = []
        walk = hashes if max_blocks is None else hashes[:max_blocks]
        for h in walk:
            blk = self._blocks.get(h)
            if blk is None:
                break
            if self.integrity is not None and blk.digest is not None:
                from ..integrity import CHECK_CORRUPT, page_digest

                computed = page_digest(
                    blk.k_data, blk.v_data, blk.k_scale, blk.v_scale
                )
                if (
                    self.integrity.check_carried(
                        h, blk.digest, computed, "remote_serve"
                    )
                    == CHECK_CORRUPT
                ):
                    # The stored copy rotted under us: destroy it before
                    # any importer installs it, revoke this holder's
                    # index entry, and tell the fleet. The served run
                    # breaks here regardless — consecutiveness is the
                    # contract.
                    del self._blocks[h]
                    self.stats["quarantined"] += 1
                    self.integrity.quarantine(h, tier="remote")
                    if self.on_events is not None:
                        from ..kvevents.events import BadBlock, BlockRemoved

                        self.on_events(
                            [
                                BlockRemoved(block_hashes=[h], medium="remote"),
                                BadBlock(block_hashes=[h], medium="remote"),
                            ]
                        )
                    log.warning(
                        "stored KV block failed digest check; quarantined",
                        block=h,
                    )
                    break
            self._blocks.move_to_end(h)
            out.append(blk)
        if out:
            self.stats["served"] += len(out)
        return out

    def purge(self, hashes: Sequence[int]) -> int:
        """Fleet revocation consumer: drop every listed block this store
        still holds (a peer published ``BadBlock`` for them). Emits the
        holder's own ``BlockRemoved(remote)`` goodbyes so the index
        forgets this replica too. Input-driven, not knob-gated — a legacy
        pod must also honor a revocation it receives. Returns blocks
        dropped."""
        dropped = [h for h in hashes if self._blocks.pop(h, None) is not None]
        if not dropped:
            return 0
        # Lazy key: appears only once a revocation actually lands, so a
        # legacy pod that never sees one keeps its exact /stats payload.
        self.stats["purged"] = self.stats.get("purged", 0) + len(dropped)
        if self.on_events is not None:
            from ..kvevents.events import BlockRemoved

            self.on_events([BlockRemoved(block_hashes=dropped, medium="remote")])
        log.warning(
            "purged revoked KV blocks from remote store", blocks=len(dropped)
        )
        return len(dropped)
