"""ctypes binding for the C++ two-level LRU block index.

Build: ``python -m llm_d_kv_cache_manager_tpu_torch.native.build``. Loading is
lazy and optional — ``available()`` gates the native index backend, and the
pure-Python ``InMemoryIndex`` remains the default.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from . import build

_LIB_NAME = "liblruindex.so"
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    path = build.built_library(_LIB_NAME)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.lruidx_create.restype = ctypes.c_void_p
        lib.lruidx_create.argtypes = [ctypes.c_uint64, ctypes.c_uint32]
        lib.lruidx_destroy.restype = None
        lib.lruidx_destroy.argtypes = [ctypes.c_void_p]
        lib.lruidx_add.restype = None
        lib.lruidx_add.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, _u64p, ctypes.c_uint64,
            _u32p, _u8p, ctypes.c_uint64,
        ]
        lib.lruidx_evict.restype = None
        lib.lruidx_evict.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
            _u32p, _u8p, ctypes.c_uint64,
        ]
        lib.lruidx_lookup.restype = ctypes.c_uint64
        lib.lruidx_lookup.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, _u64p, ctypes.c_uint64,
            _u32p, ctypes.c_uint64, _u32p, _u8p, _u32p,
        ]
        lib.lruidx_score.restype = ctypes.c_uint64
        lib.lruidx_score.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, _u64p, ctypes.c_uint64,
            _u32p, ctypes.c_uint64, _u32p, _u32p, _u64p,
        ]
        lib.lruidx_size.restype = ctypes.c_uint64
        lib.lruidx_size.argtypes = [ctypes.c_void_p]
        try:  # symbol: absent in pre-self-healing builds of the .so
            lib.lruidx_evict_pod.restype = ctypes.c_uint64
            lib.lruidx_evict_pod.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        except AttributeError:
            pass
        try:  # symbol: shared-lock read-side lookup (no LRU promote)
            lib.lruidx_lookup_ro.restype = ctypes.c_uint64
            lib.lruidx_lookup_ro.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, _u64p, ctypes.c_uint64,
                _u32p, ctypes.c_uint64, _u32p, _u8p, _u32p,
            ]
        except AttributeError:
            pass
        try:  # symbol: exact distinct-pod occupancy walk
            lib.lruidx_distinct_pods.restype = ctypes.c_uint64
            lib.lruidx_distinct_pods.argtypes = [
                ctypes.c_void_p, _u32p, ctypes.c_uint64,
            ]
        except AttributeError:
            pass
        try:  # symbol: one-call cross-shard fused scoring
            lib.lruidx_score_sharded.restype = ctypes.c_uint64
            lib.lruidx_score_sharded.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint64,
                ctypes.c_uint32, _u64p, _u32p, ctypes.c_uint64,
                _u32p, ctypes.c_uint64, _u32p, _u32p, _u64p,
            ]
        except AttributeError:
            pass
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


class NativeLru:
    """Thin RAII wrapper over the C handle (integer-id API; interning is the
    caller's concern)."""

    def __init__(self, max_keys: int, pods_per_key: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "liblruindex.so not built — run "
                "`python -m llm_d_kv_cache_manager_tpu_torch.native.build`"
            )
        self._lib = lib
        # Out-buffer sizing must track the C++ per-key cap exactly — a
        # smaller buffer would let lruidx_lookup write past the allocation.
        self.pods_per_key = max(1, pods_per_key)
        self._h = lib.lruidx_create(max_keys, pods_per_key)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.lruidx_destroy(h)

    def add(self, model: int, hashes, pod_ids, tiers) -> None:
        n_keys, n_entries = len(hashes), len(pod_ids)
        self._lib.lruidx_add(
            self._h, model,
            (ctypes.c_uint64 * n_keys)(*hashes), n_keys,
            (ctypes.c_uint32 * n_entries)(*pod_ids),
            (ctypes.c_uint8 * n_entries)(*tiers), n_entries,
        )

    def evict(self, model: int, block_hash: int, pod_ids, tiers) -> None:
        n = len(pod_ids)
        self._lib.lruidx_evict(
            self._h, model, block_hash,
            (ctypes.c_uint32 * n)(*pod_ids),
            (ctypes.c_uint8 * n)(*tiers), n,
        )

    def lookup(self, model: int, hashes, filter_ids):
        """Returns (n_processed, [per-key list of (pod_id, tier)])."""
        n_keys = len(hashes)
        n_filter = len(filter_ids)
        cap = n_keys * self.pods_per_key
        out_pods = (ctypes.c_uint32 * cap)()
        out_tiers = (ctypes.c_uint8 * cap)()
        out_counts = (ctypes.c_uint32 * n_keys)()
        processed = self._lib.lruidx_lookup(
            self._h, model,
            (ctypes.c_uint64 * n_keys)(*hashes), n_keys,
            (ctypes.c_uint32 * max(1, n_filter))(*(filter_ids or [0])),
            n_filter, out_pods, out_tiers, out_counts,
        )
        result = []
        r = 0
        for i in range(processed):
            c = out_counts[i]
            result.append([(out_pods[r + j], out_tiers[r + j]) for j in range(c)])
            r += c
        return processed, result

    @property
    def has_lookup_ro(self) -> bool:
        return hasattr(self._lib, "lruidx_lookup_ro")

    def lookup_ro(self, model: int, hashes, filter_ids):
        """Read-side lookup: same outputs and early-stop semantics as
        ``lookup``, but under the C++ shared lock with NO recency
        promotion — safe (and concurrent) against in-flight applies.
        Raises when the loaded library predates the symbol."""
        if not self.has_lookup_ro:
            raise RuntimeError(
                "liblruindex.so predates lruidx_lookup_ro — rebuild with "
                "`python -m llm_d_kv_cache_manager_tpu_torch.native.build`"
            )
        n_keys = len(hashes)
        n_filter = len(filter_ids)
        cap = n_keys * self.pods_per_key
        out_pods = (ctypes.c_uint32 * cap)()
        out_tiers = (ctypes.c_uint8 * cap)()
        out_counts = (ctypes.c_uint32 * n_keys)()
        processed = self._lib.lruidx_lookup_ro(
            self._h, model,
            (ctypes.c_uint64 * n_keys)(*hashes), n_keys,
            (ctypes.c_uint32 * max(1, n_filter))(*(filter_ids or [0])),
            n_filter, out_pods, out_tiers, out_counts,
        )
        result = []
        r = 0
        for i in range(processed):
            c = out_counts[i]
            result.append([(out_pods[r + j], out_tiers[r + j]) for j in range(c)])
            r += c
        return processed, result

    def score(self, model: int, hashes, filter_ids):
        """Fused longest-prefix scoring.

        Returns ([(pod_id, score)], hits) where hits = number of keys with a
        filter-surviving pod (the plain lookup path's hit metric)."""
        n_keys = len(hashes)
        n_filter = len(filter_ids)
        cap = self.pods_per_key
        out_pods = (ctypes.c_uint32 * cap)()
        out_scores = (ctypes.c_uint32 * cap)()
        out_hits = (ctypes.c_uint64 * 1)()
        n = self._lib.lruidx_score(
            self._h, model,
            (ctypes.c_uint64 * n_keys)(*hashes), n_keys,
            (ctypes.c_uint32 * max(1, n_filter))(*(filter_ids or [0])),
            n_filter, out_pods, out_scores, out_hits,
        )
        return [(out_pods[i], out_scores[i]) for i in range(n)], int(out_hits[0])

    def evict_pod(self, pod_id: int) -> int:
        """Remove every entry of ``pod_id``; returns entries removed. Raises
        when the loaded library predates the symbol (rebuild required)."""
        if not hasattr(self._lib, "lruidx_evict_pod"):
            raise RuntimeError(
                "liblruindex.so predates lruidx_evict_pod — rebuild with "
                "`python -m llm_d_kv_cache_manager_tpu_torch.native.build`"
            )
        return int(self._lib.lruidx_evict_pod(self._h, pod_id))

    def size(self) -> int:
        return self._lib.lruidx_size(self._h)

    def distinct_pods(self, cap: int):
        """Exact distinct pod ids currently holding >= 1 entry (shared-lock
        O(entries) walk — scrape-driven callers only). Returns None when
        the loaded library predates the symbol (caller falls back to the
        ever-interned approximation)."""
        if not hasattr(self._lib, "lruidx_distinct_pods"):
            return None
        cap = max(int(cap), 1)
        out = (ctypes.c_uint32 * cap)()
        n = int(self._lib.lruidx_distinct_pods(self._h, out, cap))
        return [out[i] for i in range(min(n, cap))]


def score_sharded_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "lruidx_score_sharded")


def score_sharded(lrus, model: int, hashes, owners, filter_ids):
    """One-call fused longest-prefix scoring over a chain whose keys are
    partitioned across ``lrus`` (``owners[i]`` indexes key i's shard):
    every shard is shared-locked inside the call (concurrent with
    applies), no LRU promotion, one GIL release round trip total. Pod ids
    MUST be interned in one table shared by all shards. Returns
    ``([(pod_id, score)], hits)`` like ``NativeLru.score``."""
    lib = _load()
    if lib is None or not hasattr(lib, "lruidx_score_sharded"):
        raise RuntimeError(
            "liblruindex.so predates lruidx_score_sharded — rebuild with "
            "`python -m llm_d_kv_cache_manager_tpu_torch.native.build`"
        )
    n_keys = len(hashes)
    n_filter = len(filter_ids)
    handles = (ctypes.c_void_p * len(lrus))(*[lru._h for lru in lrus])
    cap = max(lru.pods_per_key for lru in lrus)
    out_pods = (ctypes.c_uint32 * cap)()
    out_scores = (ctypes.c_uint32 * cap)()
    out_hits = (ctypes.c_uint64 * 1)()
    n = lib.lruidx_score_sharded(
        handles, len(lrus), model,
        (ctypes.c_uint64 * n_keys)(*hashes),
        (ctypes.c_uint32 * n_keys)(*owners), n_keys,
        (ctypes.c_uint32 * max(1, n_filter))(*(filter_ids or [0])),
        n_filter, out_pods, out_scores, out_hits,
    )
    return [(out_pods[i], out_scores[i]) for i in range(n)], int(out_hits[0])
