// Paged decode attention for Hopper (sm_90a), split over the KV history, in
// two entries that share one template:
//
//   paged_decode_bf16  (K1) replaces llm_d_kv_cache_manager_tpu/ops/
//     paged_attention.py::_decode_kernel with quantized=False: bfloat16 pools;
//   paged_decode_int8  (K1q) replaces the same kernel with quantized=True
//     (KV_QUANT_HBM=int8): int8 code pools plus one f32 scale per page per
//     (layer, kv head), [L, P, n_kv], fetched through the same block-table
//     index as the page; codes are exact in bf16, and the scales multiply
//     the float32 scores (K) and probabilities (V) of their keys.
//
// Both compute batched one-token GQA attention over the pages
// block_tables[b, :] names, up to seq_lens[b], with the current token's K/V
// optionally passed separately (has_fresh); a seq_len == 0 row gives zeros.
//
// Bound on this card: HBM bandwidth. Each (sequence, kv head) reads its
// history once, hist * head_dim * 2 (K and V) * 2 bytes (bf16) or * 1 byte
// (int8, plus 8 bytes of scales a page), and does ~4 flops per byte — far
// below the ~295 flop/byte where the tensor cores would limit. So the
// design keeps bytes in flight on every SM at any batch:
//   * split-KV grid (batch, n_kv * q_tiles, splits): a block walks pages
//     [z * pages_per_split, (z + 1) * pages_per_split) of row b for up to 8
//     of kv head h's query rows (a GQA group above 8 takes q_tiles =
//     ceil(group / 8) blocks, each reading the pages); the host picks
//     splits from shapes alone (never from seq_lens), so the launch never
//     synchronises; split_decode_kernel writes each block's partial
//     (m, l, acc) in float32 to scratch the caller allocates, and
//     combine_kernel merges the splits by log-sum-exp, adds the fresh token
//     and normalises. A split with no key writes m = -inf, l = 0, acc = 0,
//     which the merge weighs 0. The combine pass is a programmatic
//     dependent launch: its launch overlaps the split pass's tail;
//   * inside a block, 4 warps take the range's key tiles (16 bf16 keys, or
//     32 int8 keys: the same bytes) in turn, each through its own two-stage
//     cp.async ring, both stages filled at the start and each refilled as
//     soon as it is consumed: the next tile (K, V and, for int8, the keys'
//     scales) is gathered key row by key row through the block table while
//     the current one is computed, and the table itself is read a tile
//     ahead; only __syncwarp, no block-wide barrier per tile. Keys past the
//     range are zero-filled;
//   * scores on the tensor cores, transposed: S^T = K Q^T on
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate) with 16 keys as the A
//     rows and the block's query rows (up to 8, loaded straight into B
//     fragments) as the 8 columns — 16 keys per product, no warp reduction
//     per key, and no mma rows spent on padding; O^T += V^T P^T the same
//     way, P^T's fragments moved from S^T's by movmatrix, each float32
//     probability split into bf16 hi + lo parts (two products), so
//     probabilities keep ~16 bits and the kernel loses no more than its
//     float32 plain version's rounding;
//   * int8 codes go from shared memory into mma fragments by ldmatrix on
//     the int8 tile itself (16-bit units = code pairs) and an exact
//     byte-permute widening in registers — no bf16 copy of the tile. For K
//     the head dim is permuted (a lane's 4 consecutive codes feed its k
//     indices 2t, 2t+1, 2t+8, 2t+9; Q's fragments are loaded in the same
//     permutation); for V each code pair splits into two interleaved
//     head-dim tiles, undone when the output is written;
//   * scores are kept in base 2 (scale * log2 e folded in, exp2); the 4
//     warps' states merge in shared memory at the end; 64-bit offsets
//     throughout (the 8B pool is 4096 pages x 32 layers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kD = 128;        // head_dim
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;     // cp.async ring depth per warp
constexpr int kMaxGroup = 8;   // query rows a block: the 8 columns of one mma tile
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Layout {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kKeys = kQuant ? 32 : 16;              // keys per tile
  static constexpr int kRowBytes = kD * (int)sizeof(T) + 16;  // padded key row
  static constexpr int kTileBytes = kKeys * kRowBytes;
  // One ring stage: K tile, V tile, then (int8) the keys' K and V scales.
  static constexpr int kStageBytes = 2 * kTileBytes + (kQuant ? 2 * kKeys * 4 : 0);
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static constexpr int kMergeBytes = kWarps * kMaxGroup * (kD + 2) * 4;
  static constexpr int kSmem = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
};

// Code v (int8, as the byte j of w ^ 0x80808080) as a float, exactly: the
// float 2^23 + (v + 128) by byte permutation, minus 2^23 + 128.
__device__ __forceinline__ float code_at(unsigned w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | j)) - 8388736.f;
}

// bf16 pair (low = byte lo, high = byte hi) from two codes of w ^ 0x80808080;
// |v| <= 128 has at most 8 significant bits, so the floats' top halves are
// their bf16.
__device__ __forceinline__ unsigned codes_bf16x2(unsigned w, int lo, int hi) {
  return (__float_as_uint(code_at(w, lo)) >> 16) |
         (__float_as_uint(code_at(w, hi)) & 0xffff0000u);
}

// Partial results of split z of (b, h): row r of the group at
// ((b * n_kv + h) * splits + z) * group + r, acc [.., D] and (m, l) [.., 2],
// m in base 2. Block (b, y, z) writes rows r0 .. r0 + rows - 1 of kv head
// h = y / q_tiles, r0 = 8 (y % q_tiles).
template <typename T>
__global__ void __launch_bounds__(kThreads) split_decode_kernel(
    const bf16* __restrict__ q,             // [B, n_q, D]
    const T* __restrict__ k_pages,          // [P, ps, n_kv, D] (layer base)
    const T* __restrict__ v_pages,
    const float* __restrict__ k_scale,      // [P, n_kv] (layer base) or null
    const float* __restrict__ v_scale,
    const int* __restrict__ block_tables,   // [B, max_pages]
    const int* __restrict__ seq_lens,       // [B]
    float* __restrict__ part_acc,
    float* __restrict__ part_ml,
    int n_q, int n_kv, int page_size, int max_pages, int pages_per_split,
    int has_fresh, float scale) {
  using L = Layout<T>;
  constexpr int KEYS = L::kKeys;
  constexpr int MT = KEYS / 16;                  // 16-key steps a tile
  constexpr int CPR = kD * (int)sizeof(T) / 16;  // 16-byte chunks a key row
  constexpr int CPL = KEYS * CPR / 32;           // chunks a lane per tensor
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int b = blockIdx.x, z = blockIdx.z, splits = gridDim.z;
  const int group = n_q / n_kv, q_tiles = (group + kMaxGroup - 1) / kMaxGroup;
  const int h = blockIdx.y / q_tiles, r0 = (blockIdx.y % q_tiles) * kMaxGroup;
  const int rows = min(kMaxGroup, group - r0);  // this block's query rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int seq_len = seq_lens[b];
  const int hist = max(0, min(has_fresh ? seq_len - 1 : seq_len, max_pages * page_size));
  const int key0 = z * pages_per_split * page_size;
  const int key1 = min(hist, (z + 1) * pages_per_split * page_size);
  const int n_tiles = key1 > key0 ? (key1 - key0 + KEYS - 1) / KEYS : 0;
  // This warp's tiles: warp, warp + kWarps, ...
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  const int64_t part = ((int64_t)b * n_kv + h) * splits + z;

  if (n_tiles == 0) {  // a split with no key: m = -inf, l = 0, acc = 0
    for (int c = threadIdx.x; c < rows * kD; c += kThreads) {
      const int64_t row = part * group + r0 + c / kD;
      part_acc[row * kD + c % kD] = 0.f;
      if (c % kD == 0) {
        part_ml[row * 2] = -INFINITY;
        part_ml[row * 2 + 1] = 0.f;
      }
    }
    return;
  }

  unsigned char* my_ring = smem_raw + warp * kStages * L::kStageBytes;
  const int64_t slot_stride = (int64_t)n_kv * kD;

  // Lane l handles key l % KEYS of this warp's tile i: fetch_page reads its
  // page from the block table (-1 past the range) a tile ahead of its use;
  // load_tile copies tile i into ring stage `stage`, the rows' offsets
  // shuffled to the lanes that copy them.
  auto key_of = [&](int i) { return key0 + (warp + i * kWarps) * KEYS + lane % KEYS; };
  auto fetch_page = [&](int i) -> int {
    const int t = key_of(i);
    return i < my_tiles && t < key1 ? block_tables[(int64_t)b * max_pages + t / page_size] : -1;
  };
  auto load_tile = [&](int i, int stage, int page) {
    const bool ok = page >= 0;
    int64_t off = 0, sidx = 0;
    if (ok) {
      off = ((int64_t)page * page_size + key_of(i) % page_size) * slot_stride + (int64_t)h * kD;
      sidx = (int64_t)page * n_kv + h;
    }
    unsigned char* st = my_ring + stage * L::kStageBytes;
#pragma unroll
    for (int i2 = 0; i2 < CPL; ++i2) {
      const int c = lane + 32 * i2;
      const int row = c / CPR, col = (c % CPR) * 16;  // bytes
      const int64_t roff = __shfl_sync(0xffffffffu, (long long)off, row);
      const bool rok = __shfl_sync(0xffffffffu, ok, row);
      const unsigned char* ksrc = reinterpret_cast<const unsigned char*>(k_pages + roff) + col;
      const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(v_pages + roff) + col;
      cp_async16(st + row * L::kRowBytes + col, ksrc, rok);
      cp_async16(st + L::kTileBytes + row * L::kRowBytes + col, vsrc, rok);
    }
    if constexpr (L::kQuant) {
      float* sc = reinterpret_cast<float*>(st + 2 * L::kTileBytes);  // [K KEYS][V KEYS]
      cp_async4(sc + lane, k_scale + sidx, ok);
      cp_async4(sc + KEYS + lane, v_scale + sidx, ok);
    }
  };

  // Both stages fill at once; each is refilled as soon as it is consumed.
  {
    const int page0 = fetch_page(0), page1 = fetch_page(1);
    if (my_tiles > 0) load_tile(0, 0, page0);
    cp_async_commit();
    if (my_tiles > 1) load_tile(1, 1, page1);
    cp_async_commit();
  }

  // The products run transposed, so that the 16 mma rows are keys (or
  // head-dim rows) and the group's query rows are the 8 mma columns:
  // S^T = K Q^T, then O^T += V^T P^T. Q^T's B fragments (zero past the
  // block's rows) come straight from global memory while the first tiles are in
  // flight. dpos: the head-dim position of a lane's fragment half `hf` in
  // k-step kk — natural for bf16; for int8 the permutation that gives each
  // lane 4 consecutive codes of a key row.
  auto dpos = [&](int kk, int hf) {
    return L::kQuant ? kk * 16 + 4 * tq + 2 * hf : kk * 16 + 8 * hf + 2 * tq;
  };
  unsigned qb[kD / 16][2];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      qb[kk][hf] = g < rows ? *reinterpret_cast<const unsigned*>(
                                  q + ((int64_t)b * n_q + h * group + r0 + g) * kD + dpos(kk, hf))
                            : 0u;

  // This lane's state of query rows 2 tq + hq (hq = 0, 1): m in base 2, its
  // share of l, and O^T's 16-row head-dim tiles (see d_of).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[kD / 16][4];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int i = 0; i < my_tiles; ++i) {
    const int next_page = fetch_page(i + 2);  // in flight during this tile
    cp_async_wait<1>();  // tile i has landed (this lane's copies; tile i+1 may not) ...
    __syncwarp();        // ... for every lane
    const unsigned char* kt = my_ring + (i & 1) * L::kStageBytes;
    const unsigned char* vt = kt + L::kTileBytes;
    const float* sk = reinterpret_cast<const float*>(vt + L::kTileBytes);
    const float* sv = sk + KEYS;
    const int t0 = key0 + (warp + i * kWarps) * KEYS;

    // S^T for each 16-key step: sc[ks][e] is key 16 ks + g + 8 (e >> 1)
    // against query row 2 tq + (e & 1).
    float sc[MT][4];
#pragma unroll
    for (int ks = 0; ks < MT; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[ks][e] = 0.f;
      const unsigned char* krow = kt + ks * 16 * L::kRowBytes;
      if constexpr (!L::kQuant) {
        // Matrices keys 0-7 / 8-15 x d 0-7, then x d 8-15: K's A fragment.
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          unsigned ak[4];
          ldsm_x4(ak, krow + (lane & 15) * L::kRowBytes + (kk * 16 + (lane >> 4) * 8) * 2);
          mma_bf16(sc[ks], ak, qb[kk]);
        }
      } else {
        // Code pairs: matrices keys 0-7 / 8-15 x k-step kk, then x kk + 1;
        // a lane's register holds 4 consecutive codes of one key: its
        // fragment halves (a0, a2) for keys g, (a1, a3) for keys g + 8.
#pragma unroll
        for (int kk = 0; kk < kD / 16; kk += 2) {
          unsigned r[4];
          ldsm_x4(r, krow + (lane & 15) * L::kRowBytes + (kk + (lane >> 4)) * 16);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const unsigned w0 = r[2 * x] ^ 0x80808080u, w1 = r[2 * x + 1] ^ 0x80808080u;
            const unsigned ak[4] = {codes_bf16x2(w0, 0, 1), codes_bf16x2(w1, 0, 1),
                                    codes_bf16x2(w0, 2, 3), codes_bf16x2(w1, 2, 3)};
            mma_bf16(sc[ks], ak, qb[kk + x]);
          }
        }
      }
    }

    // Online softmax per query row; the row's keys lie across the 8 lanes
    // of one tq (lane bits 2-4).
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      float mt = -INFINITY;
#pragma unroll
      for (int ks = 0; ks < MT; ++ks)
#pragma unroll
        for (int e = hq; e < 4; e += 2) {
          const int c = ks * 16 + g + 8 * (e >> 1);
          float x = sc[ks][e] * scale2;
          if constexpr (L::kQuant) x *= sk[c];
          sc[ks][e] = t0 + c < key1 ? x : -INFINITY;
          mt = fmaxf(mt, sc[ks][e]);
        }
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, x));
      // The tile holds at least one key (t0 < key1), so mnew is finite.
      const float mnew = fmaxf(m[hq], mt);
      const float alpha = exp2f(m[hq] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int ks = 0; ks < MT; ++ks)
#pragma unroll
        for (int e = hq; e < 4; e += 2) {
          const float pe = exp2f(sc[ks][e] - mnew);
          rs += pe;
          if constexpr (L::kQuant) sc[ks][e] = pe * sv[ks * 16 + g + 8 * (e >> 1)];
          else sc[ks][e] = pe;
        }
      l[hq] = l[hq] * alpha + rs;
      m[hq] = mnew;
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        o[n][hq] *= alpha;
        o[n][hq + 2] *= alpha;
      }
    }

    // O^T += V^T P^T, 16 keys a step. P^T's B fragments: each float32
    // probability split into bf16 hi + lo (exact products with V's bf16),
    // the [keys x rows] pairs transposed in registers by movmatrix.
#pragma unroll
    for (int ks = 0; ks < MT; ++ks) {
      unsigned bhi[2], blo[2];
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {  // keys g (b0) and g + 8 (b1)
        const float p0 = sc[ks][2 * hk], p1 = sc[ks][2 * hk + 1];
        const float h0 = __bfloat162float(__float2bfloat16_rn(p0));
        const float h1 = __bfloat162float(__float2bfloat16_rn(p1));
        bhi[hk] = movmatrix_trans(pack_bf16x2(p0, p1));
        blo[hk] = movmatrix_trans(pack_bf16x2(p0 - h0, p1 - h1));
      }
      const unsigned char* vrow = vt + ks * 16 * L::kRowBytes;
      if constexpr (!L::kQuant) {
        // Transposed matrices keys 0-7 x d 16n + 0-7, keys 0-7 x d + 8-15,
        // keys 8-15 x ...: V^T's A fragment for head-dim tile n.
#pragma unroll
        for (int n = 0; n < kD / 16; ++n) {
          unsigned av[4];
          ldsm_x4_trans(av, vrow + ((lane & 7) + ((lane >> 4) << 3)) * L::kRowBytes +
                                (n * 16 + ((lane >> 3) & 1) * 8) * 2);
          mma_bf16(o[n], av, bhi);
          mma_bf16(o[n], av, blo);
        }
      } else {
        // Code pairs, transposed: matrices keys 0-7 / 8-15 x pairs 16c +
        // 0-7, then x pairs 16c + 8-15. A lane's register holds keys 2t,
        // 2t+1 at columns (2 pair, 2 pair + 1): bytes s and s + 2 feed
        // head-dim tile 2c + s (rows d = 2 pair + s).
#pragma unroll
        for (int c = 0; c < kD / 32; ++c) {
          unsigned r[4];
          ldsm_x4_trans(r, vrow + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::kRowBytes +
                               (16 * c + (lane >> 4) * 8) * 2);
          const unsigned w[4] = {r[0] ^ 0x80808080u, r[1] ^ 0x80808080u,
                                 r[2] ^ 0x80808080u, r[3] ^ 0x80808080u};
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            const unsigned av[4] = {codes_bf16x2(w[0], s2, s2 + 2), codes_bf16x2(w[2], s2, s2 + 2),
                                    codes_bf16x2(w[1], s2, s2 + 2), codes_bf16x2(w[3], s2, s2 + 2)};
            mma_bf16(o[2 * c + s2], av, bhi);
            mma_bf16(o[2 * c + s2], av, blo);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with stage i & 1: refill it
    if (i + 2 < my_tiles) load_tile(i + 2, i & 1, next_page);
    cp_async_commit();
  }

  // Merge the warps: each writes its rows' state over the (now idle) ring.
#pragma unroll
  for (int hq = 0; hq < 2; ++hq)
#pragma unroll
    for (int x = 4; x < 32; x <<= 1) l[hq] += __shfl_xor_sync(0xffffffffu, l[hq], x);
  __syncthreads();  // every warp is done with the ring
  float* mo = reinterpret_cast<float*>(smem_raw);  // [kWarps][kMaxGroup][kD]
  float* mml = mo + kWarps * kMaxGroup * kD;       // [kWarps][kMaxGroup][2]
#pragma unroll
  for (int hq = 0; hq < 2; ++hq) {
    const int r = 2 * tq + hq;
    if (r >= rows) continue;
    float* dst = mo + (warp * kMaxGroup + r) * kD;
#pragma unroll
    for (int n = 0; n < kD / 16; ++n)
#pragma unroll
      for (int hd = 0; hd < 2; ++hd) {
        // o[n][2 hd + hq]: head-dim row g + 8 hd of tile n, which is d =
        // 16 n + row for bf16; for int8, tile 2c + s holds d = 2 (16c +
        // row) + s.
        const int row = g + 8 * hd;
        const int d = L::kQuant ? 2 * (16 * (n >> 1) + row) + (n & 1) : 16 * n + row;
        dst[d] = o[n][2 * hd + hq];
      }
    if (g == 0) {
      mml[(warp * kMaxGroup + r) * 2] = m[hq];
      mml[(warp * kMaxGroup + r) * 2 + 1] = l[hq];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < rows * kD; c += kThreads) {
    const int r = c / kD, d = c % kD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mml[(w * kMaxGroup + r) * 2]);
    float ls = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = mml[(w * kMaxGroup + r) * 2];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);  // a warp with no key weighs 0
      ls += mml[(w * kMaxGroup + r) * 2 + 1] * wt;
      acc += mo[(w * kMaxGroup + r) * kD + d] * wt;
    }
    const int64_t row = part * group + r0 + r;
    part_acc[row * kD + d] = acc;
    if (d == 0) {
      part_ml[row * 2] = mx;
      part_ml[row * 2 + 1] = ls;
    }
  }
}

// Merges the splits of query row (b, h * group + r) by log-sum-exp (base
// 2), adds the fresh token and writes the row in bf16. Block (b, h, r) of
// kCombineWarps warps: the threads first take the splits' m in parallel
// (their max), then each warp the weighted sum of every kCombineWarps-th
// split's acc, 4 dims a lane, whose loads do not depend on each other; the
// warps' sums meet in shared memory. Launched as a programmatic dependent
// of the split pass: it waits for that grid's results before reading them.
constexpr int kCombineWarps = 8;

__global__ void __launch_bounds__(32 * kCombineWarps) combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const bf16* __restrict__ q,
    const bf16* __restrict__ fresh_k,  // [B, n_kv, D] or null
    const bf16* __restrict__ fresh_v, const int* __restrict__ seq_lens,
    bf16* __restrict__ out, int n_q, int n_kv, int splits, float scale) {
  __shared__ float red[kCombineWarps][kD + 1];
  __shared__ float mx_s[kCombineWarps];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int group = n_q / n_kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = lane * 4;
  // Split z's row: base + z * group.
  const int64_t base = ((int64_t)b * n_kv + h) * splits * group + r;
  float mx = -INFINITY;
  for (int z = threadIdx.x; z < splits; z += 32 * kCombineWarps)
    mx = fmaxf(mx, part_ml[(base + (int64_t)z * group) * 2]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) mx_s[warp] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kCombineWarps; ++w) mx = fmaxf(mx, mx_s[w]);

  float ls = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int z = warp; z < splits; z += kCombineWarps) {
    const int64_t row = base + (int64_t)z * group;
    const float ms = part_ml[row * 2];
    // A split with no key (m = -inf) weighs 0; its acc is 0.
    const float w = ms == -INFINITY ? 0.f : exp2f(ms - mx);
    ls += w * part_ml[row * 2 + 1];
    const float4 a = *reinterpret_cast<const float4*>(part_acc + row * kD + d0);
    acc[0] += w * a.x;
    acc[1] += w * a.y;
    acc[2] += w * a.z;
    acc[3] += w * a.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[warp][d0 + i] = acc[i];
  if (lane == 0) red[warp][kD] = ls;
  __syncthreads();
  if (warp != 0) return;
  ls = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.f;
#pragma unroll
  for (int w = 0; w < kCombineWarps; ++w) {
    ls += red[w][kD];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += red[w][d0 + i];
  }
  const int64_t qrow = ((int64_t)b * n_q + h * group + r) * kD + d0;
  if (fresh_k != nullptr && seq_lens[b] > 0) {
    // The current token: a one-key split, always visible to itself.
    const int64_t frow = ((int64_t)b * n_kv + h) * kD + d0;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s += __bfloat162float(q[qrow + i]) * __bfloat162float(fresh_k[frow + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s *= scale * kLog2e;
    const float mnew = fmaxf(mx, s);
    const float alpha = mx == -INFINITY ? 0.f : exp2f(mx - mnew);
    const float pf = exp2f(s - mnew);
    ls = ls * alpha + pf;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i] = acc[i] * alpha + pf * __bfloat162float(fresh_v[frow + i]);
  }
  const float inv = 1.f / (ls == 0.f ? 1.f : ls);  // len-0 row -> zeros
  uint2 packed;
  packed.x = pack_bf16x2(acc[0] * inv, acc[1] * inv);
  packed.y = pack_bf16x2(acc[2] * inv, acc[3] * inv);
  *reinterpret_cast<uint2*>(out + qrow) = packed;
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* v_scale,
                   const int* block_tables, const int* seq_lens,
                   const void* fresh_k, const void* fresh_v, void* out,
                   float* part_acc, float* part_ml, int batch, int n_q,
                   int n_kv, int page_size, int max_pages, int layer,
                   int total_pages, int splits, int pages_per_split,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Layout<T>::kSmem;
  // Above 48 KB a block's dynamic shared memory must be asked for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int64_t layer_offset = (int64_t)layer * total_pages * page_size * n_kv * kD;
  const int64_t scale_offset = (int64_t)layer * total_pages * n_kv;
  const int q_tiles = (n_q / n_kv + kMaxGroup - 1) / kMaxGroup;
  split_decode_kernel<T><<<dim3(batch, n_kv * q_tiles, splits), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k_pages) + layer_offset,
      static_cast<const T*>(v_pages) + layer_offset,
      k_scale != nullptr ? k_scale + scale_offset : nullptr,
      v_scale != nullptr ? v_scale + scale_offset : nullptr, block_tables,
      seq_lens, part_acc, part_ml, n_q, n_kv, page_size, max_pages,
      pages_per_split, fresh_k != nullptr, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The combine pass, launched while the split pass drains.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch, n_kv, n_q / n_kv);
  cfg.blockDim = dim3(32 * kCombineWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, combine_kernel, (const float*)part_acc,
                            (const float*)part_ml, static_cast<const bf16*>(q),
                            static_cast<const bf16*>(fresh_k),
                            static_cast<const bf16*>(fresh_v), seq_lens,
                            static_cast<bf16*>(out), n_q, n_kv, splits, scale);
}

bool bad_shape(int n_q, int n_kv, int head_dim, int page_size, int max_pages,
               int splits, int pages_per_split) {
  if (head_dim != kD || n_kv <= 0 || n_q <= 0 || n_q % n_kv != 0) return true;
  const int64_t group = n_q / n_kv, q_tiles = (group + kMaxGroup - 1) / kMaxGroup;
  return n_kv * q_tiles > 65535 || group > 65535 || page_size <= 0 || splits <= 0 ||
         splits > 65535 || pages_per_split <= 0 ||
         (int64_t)splits * pages_per_split < max_pages;
}

}  // namespace

// C entry points (loaded with ctypes). Pools are the full multi-layer
// [L, P, ps, n_kv, hd] arrays (scales [L, P, n_kv]), read in place at
// `layer`. part_acc [batch, n_kv, splits, group, hd] and part_ml [batch,
// n_kv, splits, group, 2] are float32 scratch the caller allocates; the
// splits of pages_per_split pages must cover the max_pages-wide table.
// head_dim 128 only; any GQA group. Each returns the cudaError_t
// of its launches (or of the shared-memory attribute call before them).
extern "C" int paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* seq_lens,
    const void* fresh_k, const void* fresh_v, void* out,
    float* part_acc, float* part_ml,
    int batch, int n_q, int n_kv, int head_dim, int page_size, int max_pages,
    int layer, int total_pages, int splits, int pages_per_split, float scale,
    void* stream) {
  if (batch == 0) return 0;
  if (bad_shape(n_q, n_kv, head_dim, page_size, max_pages, splits, pages_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<bf16>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, seq_lens, fresh_k,
      fresh_v, out, part_acc, part_ml, batch, n_q, n_kv, page_size, max_pages,
      layer, total_pages, splits, pages_per_split, scale,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int paged_decode_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale,
    const int* block_tables, const int* seq_lens,
    const void* fresh_k, const void* fresh_v, void* out,
    float* part_acc, float* part_ml,
    int batch, int n_q, int n_kv, int head_dim, int page_size, int max_pages,
    int layer, int total_pages, int splits, int pages_per_split, float scale,
    void* stream) {
  if (batch == 0) return 0;
  if (bad_shape(n_q, n_kv, head_dim, page_size, max_pages, splits, pages_per_split) ||
      k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<int8_t>(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens, fresh_k,
      fresh_v, out, part_acc, part_ml, batch, n_q, n_kv, page_size, max_pages,
      layer, total_pages, splits, pages_per_split, scale,
      static_cast<cudaStream_t>(stream)));
}
