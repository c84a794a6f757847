"""KV-capacity observability: block-lifecycle ledger + reuse-distance MRC.

Two instruments behind ``OBS_LIFECYCLE`` (off by default = bit-identical
legacy behavior, ``/stats`` legacy fields, and heartbeat/transfer/KV-event
wire bytes — everything here derives from hooks and events the process
already has, no new wire fields):

- ``BlockLifecycleLedger`` — a bounded ring recording each chain-block's
  tier transitions (allocate, hbm-evict→host-spill, prefetch bring-back,
  demote→remote, pull-back import, final evict). On a pod it hangs off
  ``BlockManager`` hooks; on the scorer it is fed from the
  ``KVEventsPool`` stream the indexer already decodes (``BlockStored``/
  ``BlockRemoved`` with their ``medium``). Surfaced as
  ``/debug/lifecycle`` (filterable by chain/block hash),
  ``kvcache_block_tier_transitions_total{from,to,reason}``, and per-tier
  residency-time histograms
  (``kvcache_block_tier_residency_seconds{tier}``).

- ``ReuseDistanceEstimator`` — a sampled LRU stack-distance estimator
  over the prefix-chain lookups ``BlockManager.allocate`` performs,
  producing a miss-ratio-vs-capacity curve (the classic MRC): with LRU
  eviction, an access hits a cache of ``C`` blocks iff its reuse
  distance (distinct blocks touched since the last access to the same
  block) is under ``C``, so ``hit(C) = P[distance < C]`` — measured once
  and valid for EVERY capacity at once. Spatial sampling is SHARDS-style
  (deterministic hash of the block's chain hash against ``sample_rate``),
  so distances stay unbiased at a fraction of the tracking cost.
  Surfaced as ``/debug/mrc`` and ``kvcache_reuse_distance_blocks``; this
  is the tier-sizing answer (how big must the host/remote tier be to
  hold hit ≥ X) and the capacity signal the ROADMAP item-2 autoscaler
  consumes.

Both are allocation-bounded and lock-guarded; the callbacks
(``on_transition``/``on_residency``/``on_distance``) are how the serving
layer and the scorer route observations into their own Prometheus
registries without this module importing either.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional, Sequence

from ..utils import get_logger

log = get_logger("obs.lifecycle")

#: the tier vocabulary of the ladder (PRs 6/12) plus "none" (not resident)
TIERS = ("none", "tpu_hbm", "host_dram", "remote")

#: transition reasons the ledger records (the pod-side hook set; the
#: scorer-side event feed uses "stored"/"removed" — what the wire can say)
REASONS = (
    "allocate",       # freshly-computed block registered in the prefix cache
    "import",         # transferred block installed (pull-back / async pull)
    "spill",          # HBM recycle kept a copy in the host-DRAM tier
    "restore",        # host→HBM bring-back inside allocate (blocking)
    "prefetch",       # host→HBM bring-back ahead of the scheduler
    "demote",         # last-copy eviction HANDED to the demotion plane
    "demote_failed",  # the pusher dropped/failed it = plain eviction
    "evict",          # last-copy eviction with no tier to keep it
    "stored",         # scorer side: BlockStored(medium) applied
    "removed",        # scorer side: BlockRemoved(medium) applied
    "drained",        # scorer side: PodDrained wiped the pod's entries
    "resync",         # scorer side: IndexSnapshot replace-all-for-pod
    "ttl_swept",      # scorer side: dead-pod TTL sweep evicted the pod
)


class BlockLifecycleLedger:
    """Bounded per-process ring of block tier transitions.

    ``record`` derives the *from* tier from tracked per-block state, so
    callers only say where a block LANDED and why; residency time in the
    departed tier is observed on every departure. Tracked state is
    bounded (``max_tracked``, LRU) so a long-lived scorer watching a
    large fleet cannot grow without bound — an evicted tracking entry
    only costs that block's next residency sample.
    """

    def __init__(
        self,
        ring: int = 4096,
        max_tracked: int = 65536,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str, str], None]] = None,
        on_residency: Optional[Callable[[str, float], None]] = None,
    ):
        self._clock = clock
        self.on_transition = on_transition
        self.on_residency = on_residency
        self._mu = threading.Lock()
        #: (pod, chain_hash) -> (tier, entered_at)
        self._state: "OrderedDict[tuple[str, int], tuple[str, float]]" = (
            OrderedDict()
        )  # guarded_by: _mu
        self._max_tracked = max(int(max_tracked), 16)
        self._ring: deque = deque(maxlen=max(int(ring), 16))  # guarded_by: _mu
        self.transitions = 0  # guarded_by: _mu
        self.tracked_evicted = 0  # guarded_by: _mu
        #: (from, to, reason) -> count (the shadow of the labeled counter)
        self._counts: dict[tuple[str, str, str], int] = {}  # guarded_by: _mu
        #: tenant -> transition count (TENANT_QOS; only ever populated by
        #: tenant-tagged records, so it stays empty — and out of
        #: snapshots — with the knob off)
        self._tenant_counts: dict[str, int] = {}  # guarded_by: _mu

    # -- write side ----------------------------------------------------------
    def _apply(self, chain_hash, tier, reason, pod, now, tenant=""):  # kvlint: holds=_mu
        """The locked half of a transition: state/ring/count mutation.
        Returns ``(frm, residency|None)`` for the caller's callbacks."""
        key = (pod, chain_hash)
        prev = self._state.pop(key, None)
        frm, since = prev if prev is not None else ("none", now)
        if tier != "none":
            self._state[key] = (tier, now)
            self._state.move_to_end(key)
            while len(self._state) > self._max_tracked:
                self._state.popitem(last=False)
                self.tracked_evicted += 1
        row = {
            "hash": chain_hash,
            "pod": pod,
            "from": frm,
            "to": tier,
            "reason": reason,
            "t": round(now, 6),
        }
        if tenant:
            # Tenant label only when tagged (TENANT_QOS on): knob-off ring
            # rows keep their exact legacy shape.
            row["tenant"] = tenant
            self._tenant_counts[tenant] = self._tenant_counts.get(tenant, 0) + 1
        self._ring.append(row)
        self.transitions += 1
        k = (frm, tier, reason)
        self._counts[k] = self._counts.get(k, 0) + 1
        return frm, (now - since if prev is not None else None)

    def _fire(self, frm: str, tier: str, reason: str, residency) -> None:
        """Observer callbacks, OUTSIDE the lock and swallowed: the hooks
        feed Prometheus registries whose fault surface is not this
        module's to propagate — a raising observer must never fail the
        allocate/evict it observes."""
        try:
            if self.on_transition is not None:
                self.on_transition(frm, tier, reason)
            if residency is not None and self.on_residency is not None:
                self.on_residency(frm, max(residency, 0.0))
        except Exception:
            log.exception("lifecycle observer callback failed")

    def record(
        self,
        chain_hash: int,
        tier: str,
        reason: str,
        pod: str = "",
        tenant: str = "",
    ) -> None:
        """One block landed in ``tier`` (``"none"`` = left the ladder) for
        ``reason``. The *from* tier and the departed tier's residency are
        derived from tracked state. ``tenant`` (TENANT_QOS) tags the ring
        row and the per-tenant counts; "" (the default, and always with
        the knob off) records the exact legacy row. Never raises —
        observability must not fail the transition it observes."""
        now = self._clock()
        with self._mu:
            frm, residency = self._apply(
                chain_hash, tier, reason, pod, now, tenant=tenant
            )
        self._fire(frm, tier, reason, residency)

    # -- scorer-side event feed (KVEventsPool) -------------------------------
    def observe_stored(
        self, pod: str, block_hashes: Sequence[int], medium: Optional[str]
    ) -> None:
        """A ``BlockStored`` applied to the index: the pod now holds these
        blocks in ``medium``'s tier (None/unknown media read as HBM, the
        reference default)."""
        tier = medium if medium in TIERS else "tpu_hbm"
        for h in block_hashes:
            self.record(h, tier, "stored", pod=pod)

    def observe_removed(
        self, pod: str, block_hashes: Sequence[int], medium: Optional[str]
    ) -> None:
        """A ``BlockRemoved`` applied to the index. A medium-less removal
        means the pod no longer holds the block in ANY tier (the pool's
        own clear-every-tier rule); a medium-tagged one only ends that
        tier's residency when it matches the tracked tier — a spill emits
        ``Removed(tpu_hbm)`` after ``Stored(host_dram)`` and must not
        erase the host-tier residency it just started."""
        for h in block_hashes:
            if medium is not None and medium in TIERS:
                with self._mu:
                    cur = self._state.get((pod, h))
                if cur is not None and cur[0] != medium:
                    continue  # stale-tier goodbye; current residency stands
            self.record(h, "none", "removed", pod=pod)

    def end_if_tier(
        self, chain_hash: int, expected_tier: str, reason: str, pod: str = ""
    ) -> None:
        """End a block's residency ONLY when it is still tracked in
        ``expected_tier`` — the correction hook for optimistic records
        (a ``demote`` recorded at hand-off is corrected with
        ``demote_failed`` when the pusher drops or fails it; if the
        block was re-registered locally meanwhile, the newer residency
        stands). Check and mutation share ONE lock hold: a re-
        registration racing the correction must never be erased by it."""
        now = self._clock()
        with self._mu:
            cur = self._state.get((pod, chain_hash))
            if cur is None or cur[0] != expected_tier:
                return
            frm, residency = self._apply(chain_hash, "none", reason, pod, now)
        self._fire(frm, "none", reason, residency)

    def observe_pod_gone(self, pod: str, reason: str) -> None:
        """Bulk ending of EVERY tracked residency for ``pod`` — the
        scorer-side mirror of ``evict_pod`` (PodDrained goodbye,
        IndexSnapshot replace-all, dead-pod TTL sweep). Per-block
        residency and transition counts are observed exactly; the ring
        gets ONE summary row (``hash: None, blocks: N``) instead of
        thousands — a drain must not wipe the ring's recent history."""
        now = self._clock()
        residencies: list[tuple[str, float]] = []
        with self._mu:
            gone = [k for k in self._state if k[0] == pod]
            for key in gone:
                tier, since = self._state.pop(key)
                residencies.append((tier, max(now - since, 0.0)))
                k = (tier, "none", reason)
                self._counts[k] = self._counts.get(k, 0) + 1
            if gone:
                self.transitions += len(gone)
                self._ring.append(
                    {
                        "hash": None,
                        "pod": pod,
                        "from": "*",
                        "to": "none",
                        "reason": reason,
                        "blocks": len(gone),
                        "t": round(now, 6),
                    }
                )
        for tier, res in residencies:
            self._fire(tier, "none", reason, res)

    # -- read side -----------------------------------------------------------
    def recent(
        self, limit: int = 100, chain_hash: Optional[int] = None
    ) -> list[dict]:
        if limit <= 0:
            return []
        with self._mu:
            rows = list(self._ring)
        if chain_hash is not None:
            rows = [r for r in rows if r["hash"] == chain_hash]
        return rows[-limit:]

    def transition_counts(self) -> dict[str, int]:
        """``"from>to:reason" -> count`` (the /stats-friendly shadow of
        the labeled Prometheus counter)."""
        with self._mu:
            return {
                f"{frm}>{to}:{reason}": n
                for (frm, to, reason), n in sorted(self._counts.items())
            }

    def resident_by_tier(self) -> dict[str, int]:
        with self._mu:
            out: dict[str, int] = {}
            for tier, _ in self._state.values():
                out[tier] = out.get(tier, 0) + 1
        return out

    def snapshot(self) -> dict:
        with self._mu:
            transitions = self.transitions
            buffered = len(self._ring)
            tracked = len(self._state)
            tracked_evicted = self.tracked_evicted
            tenant_counts = dict(self._tenant_counts)
        out = {
            "transitions": transitions,
            "buffered": buffered,
            "tracked_blocks": tracked,
            "tracked_evicted": tracked_evicted,
            "resident_by_tier": self.resident_by_tier(),
            "transition_counts": self.transition_counts(),
        }
        if tenant_counts:
            # Key appears only once a tenant-tagged record landed — i.e.
            # only with TENANT_QOS on; knob-off snapshots are unchanged.
            out["tenants"] = {
                t: n for t, n in sorted(tenant_counts.items())
            }
        return out


#: reuse-distance histogram bucket upper bounds, in blocks (powers of two:
#: capacities are page counts and the curve is read log-scale). The last
#: implicit bucket is +Inf = cold (first-ever) accesses. The ONE
#: definition shared by the pod exposition (serve.py), the scorer
#: collector, and /debug/mrc's default curve grid.
REUSE_DISTANCE_BUCKETS = tuple(2**i for i in range(17))  # 1 .. 65536

#: finite stand-in for a cold (infinite) distance when feeding a
#: Prometheus histogram: past every bucket bound (lands in +Inf) without
#: poisoning the ``_sum`` series with inf. Shared for the same reason.
COLD_DISTANCE_CLAMP = float(1 << 20)


class ReuseDistanceEstimator:
    """Sampled LRU stack-distance estimator → miss-ratio curve.

    ``observe_chain`` is called with the full prefix-hash chain of every
    allocate-time lookup (hits AND misses — the MRC needs the whole
    access stream, not just the hits that happened to land). For each
    sampled block the stack distance (distinct sampled blocks accessed
    since its last access) is computed EXACTLY via a Fenwick tree over
    access timestamps — O(log max_tracked) per sampled access, never a
    linear stack walk, so full sampling on a production allocate path
    stays cheap. Scaled by ``1/sample_rate`` the distance is an unbiased
    estimate of the true reuse distance (SHARDS). Distances are kept as
    exact scaled counts (bounded by ``max_tracked`` distinct sampled
    blocks), so ``predicted_hit_rate(C)`` answers at ANY capacity
    without bucket aliasing — the property the tier-sizing validation
    (predicted vs measured pressure-arm hit rate) rests on.
    """

    def __init__(
        self,
        sample_rate: float = 1.0,
        max_tracked: int = 8192,
        on_distance: Optional[Callable[[float], None]] = None,
    ):
        if not (0.0 < sample_rate <= 1.0):
            raise ValueError("sample_rate must be in (0, 1]")
        self.sample_rate = float(sample_rate)
        #: deterministic hash-space threshold (SHARDS): block sampled iff
        #: mix(hash) < rate * 2^64 — the same blocks are sampled on every
        #: pod and every run, so curves are comparable across replicas.
        self._threshold = int(self.sample_rate * (1 << 64))
        self._max_tracked = max(int(max_tracked), 16)
        self.on_distance = on_distance
        self._mu = threading.Lock()
        #: sampled LRU stack: chain_hash -> access timestamp; insertion
        #: order == timestamp order (timestamps only grow and an access
        #: moves its block to the end), so popitem(last=False) is both
        #: the LRU block and the minimum timestamp.
        self._stack: "OrderedDict[int, int]" = OrderedDict()  # guarded_by: _mu
        #: Fenwick tree marking live blocks' last-access timestamps; the
        #: count of marks in (t_old, now] IS the stack distance. Domain
        #: is 4x the stack cap; a full domain compacts timestamps back
        #: to 0..live-1 (amortized O(1) per access).
        self._domain = 4 * self._max_tracked  # guarded_by: _mu
        self._tree = [0] * (self._domain + 1)  # guarded_by: _mu
        self._time = 0  # next access timestamp  # guarded_by: _mu
        #: scaled reuse distance -> access count (finite distances only)
        self._distances: dict[int, int] = {}  # guarded_by: _mu
        self.accesses = 0  # every observed access (sampled or not)  # guarded_by: _mu
        self.sampled = 0  # guarded_by: _mu
        self.cold = 0  # sampled first-ever accesses (infinite distance)  # guarded_by: _mu
        self.capped = 0  # distances truncated at max_tracked (read as cold)  # guarded_by: _mu

    @staticmethod
    def _mix(h: int) -> int:
        """64-bit finalizer (splitmix64) — chain hashes are already
        uniform, but the tail bits a modulus would read are exactly the
        bits the chain construction correlates."""
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 % (1 << 64)
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB % (1 << 64)
        return h ^ (h >> 31)

    def _is_sampled(self, h: int) -> bool:
        return self._mix(h & ((1 << 64) - 1)) < self._threshold

    # -- Fenwick primitives (caller holds _mu) -------------------------------
    def _mark(self, t: int, v: int) -> None:  # kvlint: holds=_mu
        i = t + 1
        while i <= self._domain:
            self._tree[i] += v
            i += i & -i

    def _marks_through(self, t: int) -> int:  # kvlint: holds=_mu
        """Count of live marks at timestamps <= t."""
        i = t + 1
        s = 0
        while i > 0:
            s += self._tree[i]
            i -= i & -i
        return s

    def _compact(self) -> None:  # kvlint: holds=_mu
        """Timestamp domain exhausted: renumber live blocks 0..live-1 in
        LRU order and rebuild the tree. Runs once per ~3x max_tracked
        accesses — amortized O(1)."""
        self._tree = [0] * (self._domain + 1)
        t = 0
        for h in self._stack:
            self._stack[h] = t
            self._mark(t, 1)
            t += 1
        self._time = t

    # -- write side ----------------------------------------------------------
    def observe_chain(self, hashes: Sequence[int]) -> None:
        """One lookup's full prefix-hash chain, in chain order."""
        on_distance = self.on_distance
        samples: list[float] = []
        with self._mu:
            for h in hashes:
                self.accesses += 1
                if not self._is_sampled(h):
                    continue
                self.sampled += 1
                if self._time >= self._domain:
                    self._compact()
                t_new = self._time
                self._time += 1
                t_old = self._stack.pop(h, None)
                if t_old is not None:
                    self._mark(t_old, -1)
                    # Marks newer than t_old = distinct sampled blocks
                    # touched since the last access to h — the exact
                    # stack distance, in O(log domain).
                    pos = len(self._stack) - self._marks_through(t_old)
                    self._stack[h] = t_new
                    self._mark(t_new, 1)
                    d = int(round(pos / self.sample_rate))
                    self._distances[d] = self._distances.get(d, 0) + 1
                    samples.append(float(d))
                else:
                    self.cold += 1
                    self._stack[h] = t_new
                    self._mark(t_new, 1)
                    if len(self._stack) > self._max_tracked:
                        # Oldest sampled block falls off: its next access
                        # reads as cold — a capacity-capped estimator can
                        # only UNDERSTATE reuse, never invent it.
                        _, t_lru = self._stack.popitem(last=False)
                        self._mark(t_lru, -1)
                        self.capped += 1
                    samples.append(float("inf"))
        if on_distance is not None:
            for d in samples:
                on_distance(d)

    # -- read side -----------------------------------------------------------
    def predicted_hit_rate(self, capacity_blocks: int) -> Optional[float]:
        """Modeled hit rate of an LRU cache of ``capacity_blocks`` over
        the observed stream: P[reuse distance < capacity]. None until
        anything was sampled."""
        with self._mu:
            total = self.sampled
            if total == 0:
                return None
            hits = sum(
                n for d, n in self._distances.items() if d < capacity_blocks
            )
        return hits / total

    def mrc(self, capacities: Optional[Sequence[int]] = None) -> list[dict]:
        """The miss-ratio curve at the given capacities (default: the
        power-of-two bucket bounds) — ``/debug/mrc``'s rows."""
        caps = list(capacities) if capacities else list(REUSE_DISTANCE_BUCKETS)
        out = []
        for c in caps:
            hit = self.predicted_hit_rate(c)
            out.append(
                {
                    "capacity_blocks": c,
                    "predicted_hit_rate": (
                        round(hit, 4) if hit is not None else None
                    ),
                    "miss_ratio": (
                        round(1.0 - hit, 4) if hit is not None else None
                    ),
                }
            )
        return out

    def snapshot(self) -> dict:
        with self._mu:
            sampled = self.sampled
            cold = self.cold
            return {
                "sample_rate": self.sample_rate,
                "accesses": self.accesses,
                "sampled": sampled,
                "cold": cold,
                "capped": self.capped,
                "tracked_blocks": len(self._stack),
                "cold_fraction": round(cold / sampled, 4) if sampled else None,
            }


def debug_lifecycle_payload(
    ledger: Optional[BlockLifecycleLedger], query
) -> tuple[int, dict]:
    """``GET /debug/lifecycle`` body (shared by the pod server and the
    scoring API): recent transitions, filterable by ``?chain=``/``?block=``
    (the chain hash IS the block hash here) with a tolerant 400 on bad
    numbers; disabled-shaped when the knob is off."""
    if ledger is None:
        return 200, {"enabled": False, "recent": []}
    chain = query.get("chain") or query.get("block")
    if chain is not None:
        try:
            chain = int(chain)
        except ValueError:
            return 400, {"error": "invalid chain/block hash (want an int)"}
    try:
        limit = int(query.get("limit", "100"))
    except ValueError:
        return 400, {"error": "invalid limit (want a positive int)"}
    return 200, {
        "enabled": True,
        "recent": ledger.recent(limit=limit, chain_hash=chain),
        **ledger.snapshot(),
    }


def debug_mrc_payload(
    mrc: Optional[ReuseDistanceEstimator],
    tier_capacities: Optional[dict] = None,
    query=None,
) -> tuple[int, dict]:
    """``GET /debug/mrc`` body: the miss-ratio curve plus per-tier
    predicted hit rates at the ladder's cumulative capacities
    (``tier_capacities``: name -> blocks, e.g. HBM / HBM+host / fleet).
    ``?limit=`` caps curve rows with the Tracer contract (``limit <= 0``
    returns nothing); tolerant 400 on a bad limit. ``query=None`` keeps
    in-process callers (the fleet controller, the federator's join)
    limit-free."""
    if mrc is None:
        return 200, {"enabled": False}
    limit = None
    if query is not None:
        try:
            limit = int(query.get("limit", str(len(REUSE_DISTANCE_BUCKETS))))
        except ValueError:
            return 400, {"error": "invalid limit (want an int)"}
    tiers = {}
    for name, cap in (tier_capacities or {}).items():
        hit = mrc.predicted_hit_rate(int(cap))
        tiers[name] = {
            "capacity_blocks": int(cap),
            "predicted_hit_rate": round(hit, 4) if hit is not None else None,
        }
    curve = mrc.mrc()
    if limit is not None:
        curve = curve[: max(limit, 0)]
        tiers = {k: tiers[k] for k in sorted(tiers)[: max(limit, 0)]}
    return 200, {
        "enabled": True,
        "curve": curve,
        "tiers": tiers,
        **mrc.snapshot(),
    }
