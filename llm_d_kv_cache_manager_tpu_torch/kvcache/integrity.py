"""KV-block content integrity: write-time digests, verify-on-transition.

The chain hashes the whole system keys on (``hash_block`` over token ids)
verify *token identity*, never *payload content*: a flipped bit in a
host-spilled, remote-demoted, or wire-transferred page was — before this
plane — silently served, and prefix reuse amplified that one corrupt block
into every future request sharing the prefix. ``KV_INTEGRITY=1`` closes
the gap:

- **write-time digests**: a fast non-crypto checksum (chained
  ``zlib.crc32`` over KV bytes + quant scales) is computed inside the
  existing spill/demote payload-build gathers — the bytes are already in
  hand, so the hot path pays nothing new — and kept in the
  :class:`BlockIntegrity` side table keyed by block (chain) hash.
- **verify-on-transition**: host restore / prefetch bring-back, remote
  pull-back, transfer import, and migration install recompute the digest
  and compare before the page becomes servable; a low-rate background
  scrubber sweeps resident host-tier slots.
- **quarantine**: a failed check marks the bad *copy* (never the token
  identity — a freshly recomputed block may re-register under the same
  hash; that recompute IS the recovery), truncates the chain at the bad
  suffix, and the caller falls back to the cold-prefill path.

crc32 is deliberately non-cryptographic: the threat model is bit rot,
truncated DMA, and framing bugs — not an adversary forging collisions.
It is C-speed stdlib, costs ~0.3 GB/s/core less than the memcpy it rides
behind, and needs no new dependency.
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict
from typing import Optional

from ..utils import get_logger
from .metrics import collector

log = get_logger("kvcache.integrity")

#: verify outcomes (the ``outcome`` label of
#: ``kvcache_integrity_checks_total``)
CHECK_OK = "ok"
CHECK_CORRUPT = "corrupt"
#: no recorded digest to compare against (block predates KV_INTEGRITY, or
#: the side table LRU-dropped the entry) — the block is served on the
#: legacy trust model, never quarantined on absence of evidence.
CHECK_UNVERIFIED = "unverified"


def page_digest(
    k_data: bytes,
    v_data: bytes,
    k_scale: bytes = b"",
    v_scale: bytes = b"",
) -> int:
    """Content digest of one KV page's at-rest/wire representation.

    Chained crc32 over (k, v, k_scale, v_scale) — the *exact stored
    bytes*, so int8 codes digest as codes and full-width pages as raw
    dtype bytes. One digest therefore spans every hop that ships the same
    representation (spill -> restore, demote -> store -> pull-back);
    representation changes re-digest at the new write site. Each
    segment's length is folded into the chain so a byte sliding across a
    segment boundary (a framing bug, not just rot) changes the digest.
    """
    d = zlib.crc32(len(k_data).to_bytes(8, "little"))
    d = zlib.crc32(k_data, d)
    d = zlib.crc32(len(v_data).to_bytes(8, "little"), d)
    d = zlib.crc32(v_data, d)
    if k_scale or v_scale:
        d = zlib.crc32(len(k_scale).to_bytes(8, "little"), d)
        d = zlib.crc32(k_scale, d)
        d = zlib.crc32(v_scale, d)
    return d & 0xFFFFFFFF


class BlockIntegrity:
    """Digest side table + quarantine ledger for one pod's KV blocks.

    Thread-safe: written from the engine loop (spill/demote gathers,
    verify-on-transition) and read from HTTP threads (/stats) and the
    scrub scheduler. All state below is guarded by ``_mu``.
    """

    def __init__(self, table_cap: int = 65536, quarantine_cap: int = 1024):
        if table_cap <= 0:
            raise ValueError("table_cap must be > 0")
        self._mu = threading.Lock()
        self._cap = int(table_cap)
        self._qcap = max(int(quarantine_cap), 1)
        #: block hash -> recorded content digest  # guarded_by: _mu
        self._digests: "OrderedDict[int, int]" = OrderedDict()
        #: recently quarantined block hashes (bounded FIFO; the fleet's
        #: BadBlock event is the durable record, this set only feeds
        #: /stats and the route audit's ``quarantined`` cause)
        self._quarantined: "OrderedDict[int, None]" = OrderedDict()  # guarded_by: _mu
        #: monotone counters (surface via /stats "integrity" block)
        self.stats = {  # guarded_by: _mu
            "recorded": 0,
            "checks_ok": 0,
            "checks_corrupt": 0,
            "checks_unverified": 0,
            "quarantined": 0,
            "scrub_pages": 0,
            "table_evictions": 0,
        }

    def record(self, h: int, digest: int) -> None:
        """Register (or refresh) the write-time digest for block ``h``.

        Re-recording under the same hash is the *recovery* path: a
        quarantined block recomputed from scratch gets fresh bytes and a
        fresh digest, and leaves quarantine here.
        """
        with self._mu:
            if h in self._digests:
                self._digests.move_to_end(h)
            self._digests[h] = int(digest)
            self.stats["recorded"] += 1
            self._quarantined.pop(h, None)
            while len(self._digests) > self._cap:
                self._digests.popitem(last=False)
                self.stats["table_evictions"] += 1

    def expected(self, h: int) -> Optional[int]:
        with self._mu:
            d = self._digests.get(h)
            if d is not None:
                self._digests.move_to_end(h)
            return d

    def check(self, h: int, digest: int, path: str = "restore") -> str:
        """Compare a recomputed ``digest`` against the recorded one.

        Returns ``"ok"`` / ``"corrupt"`` / ``"unverified"`` (no recorded
        digest — absence of evidence never quarantines). ``path`` labels
        the transition (restore / prefetch / remote_serve / export /
        scrub) on ``kvcache_integrity_checks_total``. Does NOT quarantine
        by itself; the caller owns the recovery choreography (free the
        slot, truncate the chain, publish ``BadBlock``) and calls
        :meth:`quarantine` once that starts.
        """
        with self._mu:
            expected = self._digests.get(h)
            if expected is None:
                self.stats["checks_unverified"] += 1
                outcome = CHECK_UNVERIFIED
            elif int(digest) == expected:
                self._digests.move_to_end(h)
                self.stats["checks_ok"] += 1
                outcome = CHECK_OK
            else:
                self.stats["checks_corrupt"] += 1
                outcome = CHECK_CORRUPT
        collector.observe_integrity_check(path, outcome)
        return outcome

    def check_bytes(
        self,
        h: int,
        k_data: bytes,
        v_data: bytes,
        k_scale: bytes = b"",
        v_scale: bytes = b"",
        path: str = "restore",
    ) -> str:
        return self.check(
            h, page_digest(k_data, v_data, k_scale, v_scale), path
        )

    def check_carried(
        self, h: int, carried: Optional[int], computed: int, path: str
    ) -> str:
        """Payload-level verify for a block whose digest travelled WITH
        the bytes (transfer import / push accept / migration install):
        compare the sender's ``carried`` digest against the ``computed``
        one over the received bytes. ``carried is None`` = the sender
        predates KV_INTEGRITY (or runs with it off) — unverified, served
        on the legacy trust model."""
        with self._mu:
            if carried is None:
                self.stats["checks_unverified"] += 1
                outcome = CHECK_UNVERIFIED
            elif int(carried) == int(computed):
                self.stats["checks_ok"] += 1
                outcome = CHECK_OK
            else:
                self.stats["checks_corrupt"] += 1
                outcome = CHECK_CORRUPT
        collector.observe_integrity_check(path, outcome)
        return outcome

    def quarantine(self, h: int, tier: str = "host_dram") -> None:
        """Mark block ``h``'s local copy bad and drop its digest (the
        stored bytes it described are being destroyed). ``tier`` labels
        where the bad copy lived (host_dram / remote / wire)."""
        with self._mu:
            self._digests.pop(h, None)
            fresh = h not in self._quarantined
            if fresh:
                self._quarantined[h] = None
                self.stats["quarantined"] += 1
                while len(self._quarantined) > self._qcap:
                    self._quarantined.popitem(last=False)
        if fresh:
            collector.observe_quarantine(tier)

    def is_quarantined(self, h: int) -> bool:
        with self._mu:
            return h in self._quarantined

    def drop(self, h: int) -> None:
        """Forget the digest for ``h`` (its stored copy was evicted
        through the normal capacity path — nothing left to verify)."""
        with self._mu:
            self._digests.pop(h, None)

    def note_scrubbed(self, pages: int) -> None:
        with self._mu:
            self.stats["scrub_pages"] += pages
        collector.observe_scrub_pages(pages)

    def __len__(self) -> int:
        with self._mu:
            return len(self._digests)

    def snapshot(self) -> dict:
        with self._mu:
            out = dict(self.stats)
            out["table_entries"] = len(self._digests)
            out["quarantine_entries"] = len(self._quarantined)
            return out
