// Native two-level LRU block index — the read-path hot structure.
//
// Mirrors the semantics of kvcache/kvblock/in_memory.py (itself the parity
// port of the reference's in_memory.go two-level LRU): an LRU of
// (model, chunk_hash) -> per-key pod LRU, bounded by key count and
// pods-per-key. Lookup stops at a present-but-empty key (broken prefix
// chain); a *missing* key does not break the chain. Strings never cross
// this boundary: the Python binding interns model/pod names to u32 ids and
// tiers to u8, so the hot loop is integer-only.
//
// Thread safety: one shared_mutex over the whole index. Mutating calls
// (add/evict/evict_pod) and the promoting walks (lookup/score refresh LRU
// recency, which relinks list nodes) take the exclusive side — the same
// effective discipline as the Python/Go versions. The read-only side
// (lookup_ro) takes the SHARED side and skips promotion entirely, so any
// number of scorer-shard read fans can scan concurrently with each other
// and block only for the duration of an individual apply — the read API
// the sharded control plane serves score fan-outs from without ever
// touching a Python-level lock.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <unordered_map>
#include <vector>

namespace {

struct KeyT {
    uint64_t hash;
    uint32_t model;
    bool operator==(const KeyT& o) const {
        return hash == o.hash && model == o.model;
    }
};

struct KeyHash {
    size_t operator()(const KeyT& k) const {
        // splitmix64 over the xor-fold; chunk hashes are already uniform.
        uint64_t x = k.hash ^ (uint64_t(k.model) * 0x9E3779B97F4A7C15ull);
        x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
        x ^= x >> 27; x *= 0x94D049BB133111EBull;
        x ^= x >> 31;
        return size_t(x);
    }
};

struct Entry {
    uint32_t pod;
    uint8_t tier;
    bool operator==(const Entry& o) const {
        return pod == o.pod && tier == o.tier;
    }
};

struct Node {
    KeyT key;
    // Pod LRU: front = most recently used. Bounded by pods_per_key (small),
    // so a vector beats pointer-chasing list nodes.
    std::vector<Entry> pods;
    Node* prev = nullptr;
    Node* next = nullptr;
};

class LruIndex {
  public:
    LruIndex(uint64_t max_keys, uint32_t pods_per_key)
        : max_keys_(max_keys ? max_keys : 1),
          pods_per_key_(pods_per_key ? pods_per_key : 1) {
        map_.reserve(max_keys_ < (1u << 20) ? max_keys_ : (1u << 20));
    }

    ~LruIndex() {
        Node* n = head_;
        while (n) { Node* nx = n->next; delete n; n = nx; }
    }

    void add(uint32_t model, const uint64_t* hashes, uint64_t n_keys,
             const uint32_t* pods, const uint8_t* tiers, uint64_t n_entries) {
        std::unique_lock<std::shared_mutex> g(mu_);
        for (uint64_t i = 0; i < n_keys; ++i) {
            Node* node = get_or_create({hashes[i], model});
            for (uint64_t j = 0; j < n_entries; ++j) {
                touch_pod(node, Entry{pods[j], tiers[j]});
            }
        }
    }

    void evict(uint32_t model, uint64_t hash, const uint32_t* pods,
               const uint8_t* tiers, uint64_t n_entries) {
        std::unique_lock<std::shared_mutex> g(mu_);
        auto it = map_.find({hash, model});
        if (it == map_.end()) return;
        Node* node = it->second;
        for (uint64_t j = 0; j < n_entries; ++j) {
            Entry e{pods[j], tiers[j]};
            for (size_t p = 0; p < node->pods.size(); ++p) {
                if (node->pods[p] == e) {
                    node->pods.erase(node->pods.begin() + long(p));
                    break;
                }
            }
        }
        if (node->pods.empty()) remove_node(node);
    }

    // Returns the number of keys processed; processing stops early (before
    // key i) when key i exists with an empty pod set. out_counts[i] = pods
    // written for key i (0 for missing or fully-filtered keys).
    uint64_t lookup(uint32_t model, const uint64_t* hashes, uint64_t n_keys,
                    const uint32_t* filter, uint64_t n_filter,
                    uint32_t* out_pods, uint8_t* out_tiers,
                    uint32_t* out_counts) {
        std::unique_lock<std::shared_mutex> g(mu_);
        uint64_t w = 0;
        for (uint64_t i = 0; i < n_keys; ++i) {
            auto it = map_.find({hashes[i], model});
            if (it == map_.end()) {            // missing: chain continues
                out_counts[i] = 0;
                continue;
            }
            Node* node = it->second;
            promote(node);                      // lookup refreshes key recency
            if (node->pods.empty()) return i;   // present-but-empty: stop
            uint32_t c = 0;
            for (const Entry& e : node->pods) {
                if (n_filter) {
                    bool ok = false;
                    for (uint64_t f = 0; f < n_filter; ++f) {
                        if (filter[f] == e.pod) { ok = true; break; }
                    }
                    if (!ok) continue;
                }
                out_pods[w] = e.pod;
                out_tiers[w] = e.tier;
                ++w;
                ++c;
            }
            out_counts[i] = c;
        }
        return n_keys;
    }

    // Read-only lookup: identical walk and outputs to lookup(), but takes
    // the SHARED lock and never promotes recency — safe under concurrent
    // apply, and many readers proceed in parallel. The price is that a
    // read-side scan leaves LRU order untouched (a key served only via
    // lookup_ro ages as if unread); the sharded read fan accepts that so
    // score reads never serialise against event ingest.
    uint64_t lookup_ro(uint32_t model, const uint64_t* hashes,
                       uint64_t n_keys, const uint32_t* filter,
                       uint64_t n_filter, uint32_t* out_pods,
                       uint8_t* out_tiers, uint32_t* out_counts) const {
        std::shared_lock<std::shared_mutex> g(mu_);
        uint64_t w = 0;
        for (uint64_t i = 0; i < n_keys; ++i) {
            auto it = map_.find({hashes[i], model});
            if (it == map_.end()) {            // missing: chain continues
                out_counts[i] = 0;
                continue;
            }
            const Node* node = it->second;
            if (node->pods.empty()) return i;   // present-but-empty: stop
            uint32_t c = 0;
            for (const Entry& e : node->pods) {
                if (n_filter) {
                    bool ok = false;
                    for (uint64_t f = 0; f < n_filter; ++f) {
                        if (filter[f] == e.pod) { ok = true; break; }
                    }
                    if (!ok) continue;
                }
                out_pods[w] = e.pod;
                out_tiers[w] = e.tier;
                ++w;
                ++c;
            }
            out_counts[i] = c;
        }
        return n_keys;
    }

    // Fused longest-prefix scoring (the read path's lookup+score in one
    // call). Scoring semantics of kvcache/scorer.py LongestPrefixScorer:
    // pods hit at key 0 seed the active set with score 1; each following key
    // intersects it and increments the survivors; any miss (absent key or
    // empty intersection) ends the streak. Pod ids are deduped across tiers.
    //
    // The WALK matches InMemoryIndex.lookup exactly — every present key in
    // the chain is LRU-promoted even past holes or after the streak dies,
    // and only a present-but-empty key stops the walk — so backend recency
    // behavior is identical whether the fused or two-step path runs.
    // out_hits receives the number of keys with >=1 filter-surviving pod
    // (the plain path's lookup_hits metric). Returns the number of scored
    // pods written to out arrays (bounded by pods_per_key).
    uint64_t score(uint32_t model, const uint64_t* hashes, uint64_t n_keys,
                   const uint32_t* filter, uint64_t n_filter,
                   uint32_t* out_pods, uint32_t* out_scores,
                   uint64_t* out_hits) {
        std::unique_lock<std::shared_mutex> g(mu_);
        if (out_hits) *out_hits = 0;
        if (n_keys == 0) return 0;

        std::vector<uint32_t> scored_pods;   // pods seeded at key 0 (dedup)
        std::vector<uint32_t> scores;
        std::vector<uint32_t> active;        // indices into scored_pods
        bool streak = true;

        auto visible = [&](uint32_t pod) {
            if (!n_filter) return true;
            for (uint64_t f = 0; f < n_filter; ++f)
                if (filter[f] == pod) return true;
            return false;
        };

        for (uint64_t i = 0; i < n_keys; ++i) {
            auto it = map_.find({hashes[i], model});
            if (it == map_.end()) {  // hole: streak dies, walk continues
                streak = false;
                continue;
            }
            Node* node = it->second;
            promote(node);
            if (node->pods.empty()) break;  // lookup's early-stop

            if (out_hits) {
                for (const Entry& e : node->pods) {
                    if (visible(e.pod)) { ++*out_hits; break; }
                }
            }
            if (!streak) continue;

            if (i == 0) {
                for (const Entry& e : node->pods) {
                    if (!visible(e.pod)) continue;
                    bool seen = false;
                    for (uint32_t p : scored_pods)
                        if (p == e.pod) { seen = true; break; }
                    if (seen) continue;
                    active.push_back(uint32_t(scored_pods.size()));
                    scored_pods.push_back(e.pod);
                    scores.push_back(1);
                }
            } else {
                std::vector<uint32_t> next;
                next.reserve(active.size());
                for (uint32_t idx : active) {
                    for (const Entry& e : node->pods) {
                        if (e.pod == scored_pods[idx]) {
                            scores[idx] += 1;
                            next.push_back(idx);
                            break;
                        }
                    }
                }
                active.swap(next);
            }
            if (active.empty()) streak = false;
        }

        for (size_t i = 0; i < scored_pods.size(); ++i) {
            out_pods[i] = scored_pods[i];
            out_scores[i] = scores[i];
        }
        return scored_pods.size();
    }

    // Fleet self-healing sweep: remove every entry of `pod` (all models,
    // all tiers), deleting keys whose pod set empties. Walks the LRU list
    // once without touching recency. Returns entries removed.
    uint64_t evict_pod(uint32_t pod) {
        std::unique_lock<std::shared_mutex> g(mu_);
        uint64_t removed = 0;
        Node* n = head_;
        while (n) {
            Node* next = n->next;
            auto& v = n->pods;
            for (size_t p = v.size(); p > 0; --p) {
                if (v[p - 1].pod == pod) {
                    v.erase(v.begin() + long(p - 1));
                    ++removed;
                }
            }
            if (v.empty()) remove_node(n);
            n = next;
        }
        return removed;
    }

    uint64_t size() {
        std::unique_lock<std::shared_mutex> g(mu_);
        return map_.size();
    }

    // Read-only node fetch for the cross-shard fused scorer. Caller must
    // hold a shared lock on mutex() for the duration of use.
    const std::vector<Entry>* find_ro(uint32_t model, uint64_t hash) const {
        auto it = map_.find({hash, model});
        return it == map_.end() ? nullptr : &it->second->pods;
    }

    // Distinct pods currently holding >= 1 entry: exact occupancy for the
    // kvcache_index_pods / kvcache_index_shard_pods gauges (scrape-driven
    // O(entries) walk under the shared lock; recency untouched). Writes up
    // to `cap` pod ids into out_ids, returns the distinct count.
    uint64_t distinct_pods(uint32_t* out_ids, uint64_t cap) const {
        std::shared_lock<std::shared_mutex> g(mu_);
        std::unordered_map<uint32_t, bool> seen;
        uint64_t w = 0;
        for (const Node* n = head_; n; n = n->next) {
            for (const Entry& e : n->pods) {
                auto ins = seen.emplace(e.pod, true);
                if (ins.second && w < cap) out_ids[w++] = e.pod;
            }
        }
        return seen.size();
    }

    std::shared_mutex& mutex() const { return mu_; }

  private:
    Node* get_or_create(KeyT key) {
        auto it = map_.find(key);
        if (it != map_.end()) {
            promote(it->second);
            return it->second;
        }
        Node* node = new Node();
        node->key = key;
        node->pods.reserve(pods_per_key_);
        map_.emplace(key, node);
        push_front(node);
        if (map_.size() > max_keys_) remove_node(tail_);  // LRU key eviction
        return node;
    }

    void touch_pod(Node* node, Entry e) {
        auto& v = node->pods;
        for (size_t p = 0; p < v.size(); ++p) {
            if (v[p] == e) {                    // move-to-front
                v.erase(v.begin() + long(p));
                v.insert(v.begin(), e);
                return;
            }
        }
        v.insert(v.begin(), e);
        if (v.size() > pods_per_key_) v.pop_back();  // pod LRU eviction
    }

    void push_front(Node* node) {
        node->prev = nullptr;
        node->next = head_;
        if (head_) head_->prev = node;
        head_ = node;
        if (!tail_) tail_ = node;
    }

    void unlink(Node* node) {
        if (node->prev) node->prev->next = node->next; else head_ = node->next;
        if (node->next) node->next->prev = node->prev; else tail_ = node->prev;
        node->prev = node->next = nullptr;
    }

    void promote(Node* node) {
        if (node == head_) return;
        unlink(node);
        push_front(node);
    }

    void remove_node(Node* node) {
        unlink(node);
        map_.erase(node->key);
        delete node;
    }

    uint64_t max_keys_;
    uint32_t pods_per_key_;
    mutable std::shared_mutex mu_;
    std::unordered_map<KeyT, Node*, KeyHash> map_;
    Node* head_ = nullptr;
    Node* tail_ = nullptr;
};

// Cross-shard fused longest-prefix scoring: ONE call walks a chain whose
// keys are partitioned across several LruIndex instances (owners[i] names
// key i's shard), under every touched shard's SHARED lock — concurrent
// with applies on all shards, no recency mutation, and a single
// GIL-release round trip from Python instead of one per shard. Pod ids
// must be interned in one shared table across the shards (the Python
// binding's shard-group constructor guarantees it); scoring semantics are
// identical to LruIndex::score.
uint64_t score_sharded_impl(LruIndex** shards, uint64_t n_shards,
                            uint32_t model, const uint64_t* hashes,
                            const uint32_t* owners, uint64_t n_keys,
                            const uint32_t* filter, uint64_t n_filter,
                            uint32_t* out_pods, uint32_t* out_scores,
                            uint64_t* out_hits) {
    if (out_hits) *out_hits = 0;
    if (n_keys == 0 || n_shards == 0) return 0;

    // Shared-lock every distinct shard once, in address order (a canonical
    // order makes multi-lock acquisition cycle-free by construction).
    std::vector<LruIndex*> uniq(shards, shards + n_shards);
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    std::vector<std::shared_lock<std::shared_mutex>> locks;
    locks.reserve(uniq.size());
    for (LruIndex* s : uniq) locks.emplace_back(s->mutex());

    std::vector<uint32_t> scored_pods;
    std::vector<uint32_t> scores;
    std::vector<uint32_t> active;
    bool streak = true;

    auto visible = [&](uint32_t pod) {
        if (!n_filter) return true;
        for (uint64_t f = 0; f < n_filter; ++f)
            if (filter[f] == pod) return true;
        return false;
    };

    for (uint64_t i = 0; i < n_keys; ++i) {
        if (owners[i] >= n_shards) { streak = false; continue; }
        const std::vector<Entry>* pods =
            shards[owners[i]]->find_ro(model, hashes[i]);
        if (pods == nullptr) {  // hole: streak dies, walk continues
            streak = false;
            continue;
        }
        if (pods->empty()) break;  // lookup's early-stop

        if (out_hits) {
            for (const Entry& e : *pods) {
                if (visible(e.pod)) { ++*out_hits; break; }
            }
        }
        if (!streak) continue;

        if (i == 0) {
            for (const Entry& e : *pods) {
                if (!visible(e.pod)) continue;
                bool seen = false;
                for (uint32_t p : scored_pods)
                    if (p == e.pod) { seen = true; break; }
                if (seen) continue;
                active.push_back(uint32_t(scored_pods.size()));
                scored_pods.push_back(e.pod);
                scores.push_back(1);
            }
        } else {
            std::vector<uint32_t> next;
            next.reserve(active.size());
            for (uint32_t idx : active) {
                for (const Entry& e : *pods) {
                    if (e.pod == scored_pods[idx]) {
                        scores[idx] += 1;
                        next.push_back(idx);
                        break;
                    }
                }
            }
            active.swap(next);
        }
        if (active.empty()) streak = false;
    }

    for (size_t i = 0; i < scored_pods.size(); ++i) {
        out_pods[i] = scored_pods[i];
        out_scores[i] = scores[i];
    }
    return scored_pods.size();
}

}  // namespace

extern "C" {

void* lruidx_create(uint64_t max_keys, uint32_t pods_per_key) {
    return new LruIndex(max_keys, pods_per_key);
}

void lruidx_destroy(void* h) { delete static_cast<LruIndex*>(h); }

void lruidx_add(void* h, uint32_t model, const uint64_t* hashes,
                uint64_t n_keys, const uint32_t* pods, const uint8_t* tiers,
                uint64_t n_entries) {
    static_cast<LruIndex*>(h)->add(model, hashes, n_keys, pods, tiers,
                                   n_entries);
}

void lruidx_evict(void* h, uint32_t model, uint64_t hash,
                  const uint32_t* pods, const uint8_t* tiers,
                  uint64_t n_entries) {
    static_cast<LruIndex*>(h)->evict(model, hash, pods, tiers, n_entries);
}

uint64_t lruidx_lookup(void* h, uint32_t model, const uint64_t* hashes,
                       uint64_t n_keys, const uint32_t* filter,
                       uint64_t n_filter, uint32_t* out_pods,
                       uint8_t* out_tiers, uint32_t* out_counts) {
    return static_cast<LruIndex*>(h)->lookup(model, hashes, n_keys, filter,
                                             n_filter, out_pods, out_tiers,
                                             out_counts);
}

uint64_t lruidx_lookup_ro(void* h, uint32_t model, const uint64_t* hashes,
                          uint64_t n_keys, const uint32_t* filter,
                          uint64_t n_filter, uint32_t* out_pods,
                          uint8_t* out_tiers, uint32_t* out_counts) {
    return static_cast<LruIndex*>(h)->lookup_ro(model, hashes, n_keys, filter,
                                                n_filter, out_pods, out_tiers,
                                                out_counts);
}

uint64_t lruidx_score(void* h, uint32_t model, const uint64_t* hashes,
                      uint64_t n_keys, const uint32_t* filter,
                      uint64_t n_filter, uint32_t* out_pods,
                      uint32_t* out_scores, uint64_t* out_hits) {
    return static_cast<LruIndex*>(h)->score(model, hashes, n_keys, filter,
                                            n_filter, out_pods, out_scores,
                                            out_hits);
}

uint64_t lruidx_evict_pod(void* h, uint32_t pod) {
    return static_cast<LruIndex*>(h)->evict_pod(pod);
}

uint64_t lruidx_distinct_pods(void* h, uint32_t* out_ids, uint64_t cap) {
    return static_cast<LruIndex*>(h)->distinct_pods(out_ids, cap);
}

uint64_t lruidx_score_sharded(void** shard_handles, uint64_t n_shards,
                              uint32_t model, const uint64_t* hashes,
                              const uint32_t* owners, uint64_t n_keys,
                              const uint32_t* filter, uint64_t n_filter,
                              uint32_t* out_pods, uint32_t* out_scores,
                              uint64_t* out_hits) {
    return score_sharded_impl(reinterpret_cast<LruIndex**>(shard_handles),
                              n_shards, model, hashes, owners, n_keys,
                              filter, n_filter, out_pods, out_scores,
                              out_hits);
}

uint64_t lruidx_size(void* h) { return static_cast<LruIndex*>(h)->size(); }

}  // extern "C"
