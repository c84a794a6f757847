// Grouped (ragged) matmul for Hopper (sm_90a): the MoE expert FFN products.
//
//   out[r, :] = lhs[r, :] @ rhs[g(r)]          (bf16 experts, K4)
//   out[r, :] = (lhs[r, :] @ q[g(r)]) * scale[g(r), 0, :]   (int8 experts, K5)
//
// over rows sorted by expert: group g owns the rows
// [sum(group_sizes[:g]), sum(group_sizes[:g + 1])). lhs [rows, d] bf16,
// rhs [E, d, f] bf16 or int8 codes with f32 scales [E, 1, f], f32
// accumulation, output [rows, f] bf16. Rows past the last group are zero.
//
// Replaces:
//   K4  llm_d_kv_cache_manager_tpu/ops/gmm.py:115 _gmm_library (megablox gmm)
//   K5  llm_d_kv_cache_manager_tpu/ops/gmm.py:149 _int8_gmm_kernel (via _gmm_int8)
//
// What bounds them on this card, at Qwen3-30B-A3B widths (d, f) =
// (2048, 768) and (768, 2048), 128 experts, top-8:
//   * prefill (65,536 rows in ~512-row groups): operations — 2*rows*d*f =
//     206 GFLOP a call against ~8 MB of weights read per expert slice;
//   * decode (64 rows, mostly one row per expert): bytes — each active
//     expert's [d, f] slice (3.1 MB bf16, 1.6 MB int8) is read for one or
//     two rows, so the call is a GEMV over ~50 expert slices.
//
// Design (simple and correct first; wgmma and TMA are later work):
//   * Tiles aligned to groups. On the TPU megablox visits a boundary row
//     tile once per group it touches and stores masked rows into the same
//     output tile, which is safe only because the grid runs in order. Here
//     blocks run in parallel, so every row tile starts at its group's own
//     offset: no two blocks share an output row, no read-modify-write.
//   * No host synchronisation. group_sizes stays on the device. The grid
//     is sized by the upper bound ceil(rows / TM) + E + 1 row tiles (each
//     non-empty group adds at most one partial tile; the +1 is the zero
//     tail). Each block scans group_sizes in shared memory (one warp,
//     shuffles), finds its (group, row start) by a binary search over the
//     tile offsets, and returns at once if it lies past the real count.
//   * Tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//     fed by ldmatrix from shared-memory tiles whose rows are padded by
//     16 bytes so the 8 rows of each ldmatrix phase hit distinct banks.
//     Each warp owns a WM x WN block of the tile's output.
//   * Two tile shapes, picked from host integers only (rows, E): for
//     decode-shaped calls (< 16 rows per group on average) 16-row tiles
//     stream a 64 x 128 weight tile per step (16 KB bf16), each weight
//     byte read from shared memory once, so the call runs at the rate the
//     weights arrive; otherwise 128 x 128 tiles over 8 warps of 64 x 32.
//   * 16-byte loads along f, which is contiguous in rhs[e]; the next k
//     tile is loaded into registers while the current one is multiplied
//     from shared memory. int8 codes are converted to bf16 as they enter
//     shared memory — exact, since |q| <= 127 fits bf16's significand —
//     so every product is exact and only the f32 sums round.
//   * K5 applies scale[g, 0, n] to the f32 accumulator in the epilogue (one
//     scale row serves the whole tile: the group is constant in it), then
//     rounds once to bf16 — the function of the JAX kernel path.
//   * 64-bit offsets: one expert stack holds 201 M elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 1024;

// 16 int8 codes to 16 bf16 (two 16-byte halves), exactly: each code v
// becomes the float 2^23 + (v + 128) by byte permutation, minus 2^23 + 128;
// |v| <= 127 has at most 7 significant bits, so the float's top 16 bits
// are its bf16.
__device__ __forceinline__ void i8x16_to_bf16(const uint4& c, uint4& lo, uint4& hi) {
  const unsigned w[4] = {c.x ^ 0x80808080u, c.y ^ 0x80808080u, c.z ^ 0x80808080u,
                         c.w ^ 0x80808080u};
  unsigned h[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u | j)) - 8388736.f;
    h[2 * i] = (__float_as_uint(f[0]) >> 16) | (__float_as_uint(f[1]) & 0xffff0000u);
    h[2 * i + 1] = (__float_as_uint(f[2]) >> 16) | (__float_as_uint(f[3]) & 0xffff0000u);
  }
  lo = make_uint4(h[0], h[1], h[2], h[3]);
  hi = make_uint4(h[4], h[5], h[6], h[7]);
}

template <typename BT>
struct BTraits;
template <>
struct BTraits<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;  // elements per 16-byte load
  static constexpr bool kScaled = false;
};
template <>
struct BTraits<int8_t> {
  static constexpr int kPerChunk = 16;
  static constexpr bool kScaled = true;
};

// Two floats rounded to bf16 and packed into 32 bits (low = first).
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane i addresses one row.
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major).
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// TM x TN output tile per block over TK-deep k tiles; (TM / WM) x (TN / WN)
// warps, each computing WM x WN with (WM / 16) x (WN / 8) mma tiles.
template <typename BT, int TM, int TN, int TK, int WM, int WN>
__global__ void __launch_bounds__((TM / WM) * (TN / WN) * 32)
grouped_matmul_kernel(const __nv_bfloat16* __restrict__ lhs,  // [rows, d]
                      const BT* __restrict__ rhs,             // [E, d, f]
                      const float* __restrict__ scale,        // [E, 1, f] (K5)
                      const int* __restrict__ group_sizes,    // [E]
                      __nv_bfloat16* __restrict__ out,        // [rows, f]
                      int rows, int d, int f, int n_groups) {
  constexpr int WARPS_N = TN / WN;
  constexpr int THREADS = (TM / WM) * WARPS_N * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int LDA = TK + 8, LDB = TN + 8;  // shared rows, padded by 16 bytes
  constexpr int BPC = BTraits<BT>::kPerChunk;
  constexpr int A_CHUNKS = TM * TK / 8;  // 16-byte chunks of the lhs tile
  constexpr int B_CHUNKS = TK * TN / BPC;
  constexpr int A_PER_T = (A_CHUNKS + THREADS - 1) / THREADS;
  constexpr int B_PER_T = (B_CHUNKS + THREADS - 1) / THREADS;
  static_assert(TK % 16 == 0 && WM % 16 == 0 && WN % 16 == 0 && TN % BPC == 0, "tile shape");

  // row_off[g]: first row of group g (g = n_groups is the zero tail, which
  // ends at rows); tile_off[g]: first row tile of group g.
  __shared__ int row_off[kMaxGroups + 2];
  __shared__ int tile_off[kMaxGroups + 2];
  __shared__ __align__(16) __nv_bfloat16 As[TM * LDA];  // [TM][TK] lhs tile
  __shared__ __align__(16) __nv_bfloat16 Bs[TK * LDB];  // [TK][TN] weight tile

  const int tid = threadIdx.x;
  if (tid < 32) {
    const int lane = tid;
    // Row offsets: a scan of max(size, 0), clamped to rows so that no read
    // or write can leave the arrays whatever group_sizes holds.
    int per = (n_groups + 31) / 32;
    int lo = min(lane * per, n_groups), hi = min(lo + per, n_groups);
    long long s = 0;
    for (int g = lo; g < hi; ++g) s += max(group_sizes[g], 0);
    const long long inc = warp_inclusive_scan(s, lane);
    long long off = inc - s;
    for (int g = lo; g < hi; ++g) {
      row_off[g] = (int)min(off, (long long)rows);
      off += max(group_sizes[g], 0);
    }
    if (lane == 31) {
      row_off[n_groups] = (int)min(inc, (long long)rows);
      row_off[n_groups + 1] = rows;
    }
    __syncwarp();
    // Tile offsets over n_groups + 1 groups (the tail included).
    const int g1 = n_groups + 1;
    per = (g1 + 31) / 32;
    lo = min(lane * per, g1);
    hi = min(lo + per, g1);
    int t = 0;
    for (int g = lo; g < hi; ++g) t += (row_off[g + 1] - row_off[g] + TM - 1) / TM;
    const int tinc = warp_inclusive_scan(t, lane);
    int toff = tinc - t;
    for (int g = lo; g < hi; ++g) {
      tile_off[g] = toff;
      toff += (row_off[g + 1] - row_off[g] + TM - 1) / TM;
    }
    if (lane == 31) tile_off[g1] = tinc;
  }
  __syncthreads();

  const int tile = blockIdx.x;
  if (tile >= tile_off[n_groups + 1]) return;  // past the real tile count
  // The group owning this tile: the largest g with tile_off[g] <= tile
  // (an empty group shares its offset with the next one).
  int lo = 0, hi = n_groups + 1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_off[mid] <= tile) lo = mid; else hi = mid;
  }
  const int g = lo;
  const int r0 = row_off[g] + (tile - tile_off[g]) * TM;
  const int r1 = min(r0 + TM, row_off[g + 1]);
  const int n0 = blockIdx.y * TN;

  if (g == n_groups) {  // rows past the last group: zeros
    for (int c = tid; c < TM * TN; c += THREADS) {
      const int r = r0 + c / TN, n = n0 + c % TN;
      if (r < r1 && n < f) out[(int64_t)r * f + n] = __float2bfloat16_rn(0.f);
    }
    return;
  }

  const BT* bbase = rhs + (int64_t)g * d * f;
  uint4 a_reg[A_PER_T];
  uint4 b_reg[B_PER_T];

  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int c = tid + i * THREADS;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const int m = c / (TK / 8), k = k0 + (c % (TK / 8)) * 8;
      if (c < A_CHUNKS && r0 + m < r1 && k < d)
        v = *reinterpret_cast<const uint4*>(lhs + (int64_t)(r0 + m) * d + k);
      a_reg[i] = v;
    }
#pragma unroll
    for (int i = 0; i < B_PER_T; ++i) {
      const int c = tid + i * THREADS;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      const int k = k0 + c / (TN / BPC), n = n0 + (c % (TN / BPC)) * BPC;
      if (c < B_CHUNKS && k < d && n < f)
        v = *reinterpret_cast<const uint4*>(bbase + (int64_t)k * f + n);
      b_reg[i] = v;
    }
  };

  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int c = tid + i * THREADS;
      if (c < A_CHUNKS)
        *reinterpret_cast<uint4*>(&As[(c / (TK / 8)) * LDA + (c % (TK / 8)) * 8]) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER_T; ++i) {
      const int c = tid + i * THREADS;
      if (c < B_CHUNKS) {
        __nv_bfloat16* dst = &Bs[(c / (TN / BPC)) * LDB + (c % (TN / BPC)) * BPC];
        if constexpr (BTraits<BT>::kScaled) {
          uint4 lo, hi;
          i8x16_to_bf16(b_reg[i], lo, hi);
          reinterpret_cast<uint4*>(dst)[0] = lo;
          reinterpret_cast<uint4*>(dst)[1] = hi;
        } else {
          *reinterpret_cast<uint4*>(dst) = b_reg[i];
        }
      }
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int k_tiles = (d + TK - 1) / TK;
  load_tiles(0);
  store_tiles();
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const bool more = kt + 1 < k_tiles;
    if (more) load_tiles((kt + 1) * TK);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < TK; ks += 16) {
      unsigned af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], &As[(wm0 + i * 16 + (lane & 15)) * LDA + ks + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        unsigned r[4];
        ldsm_x4_trans(r, &Bs[(ks + (lane & 15)) * LDB + wn0 + j * 8 + (lane >> 4) * 8]);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();  // every product of this tile is done
    if (more) {
      store_tiles();
      __syncthreads();
    }
  }

  // Epilogue: per-column scale (K5), one rounding to bf16, rows of this
  // group only. Lane holds rows lane / 4 (+ 8), columns 2 (lane % 4) + {0, 1}.
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int col = n0 + wn0 + j * 8 + (lane & 3) * 2;
    if (col >= f) continue;
    float s0 = 1.f, s1 = 1.f;
    if constexpr (BTraits<BT>::kScaled) {
      s0 = scale[(int64_t)g * f + col];
      s1 = scale[(int64_t)g * f + col + 1];
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm0 + i * 16 + (lane >> 2) + h * 8;
        if (r < r1)
          *reinterpret_cast<unsigned*>(out + (int64_t)r * f + col) =
              pack_bf16x2(acc[i][j][2 * h] * s0, acc[i][j][2 * h + 1] * s1);
      }
  }
}

template <typename BT, int TM, int TN, int TK, int WM, int WN>
cudaError_t launch_tiles(const void* lhs, const void* rhs, const float* scale,
                         const int* group_sizes, void* out, int rows, int d,
                         int f, int n_groups, cudaStream_t stream) {
  // Upper bound on group-aligned row tiles: each non-empty group adds at
  // most one partial tile, and the zero tail one more.
  dim3 grid((rows + TM - 1) / TM + n_groups + 1, (f + TN - 1) / TN);
  grouped_matmul_kernel<BT, TM, TN, TK, WM, WN>
      <<<grid, (TM / WM) * (TN / WN) * 32, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(lhs), static_cast<const BT*>(rhs),
          scale, group_sizes, static_cast<__nv_bfloat16*>(out), rows, d, f,
          n_groups);
  return cudaGetLastError();
}

template <typename BT>
cudaError_t launch(const void* lhs, const void* rhs, const float* scale,
                   const int* group_sizes, void* out, int rows, int d, int f,
                   int n_groups, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (n_groups < 1 || n_groups > kMaxGroups || d < 1 || d % 8 != 0 ||
      f < 1 || f % BTraits<BT>::kPerChunk != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Decode-shaped calls stream the weights: one mma row tile, deep k tiles.
  if ((long long)rows < 16LL * n_groups)
    return launch_tiles<BT, 16, 128, 64, 16, 32>(lhs, rhs, scale, group_sizes, out,
                                                rows, d, f, n_groups, s);
  return launch_tiles<BT, 128, 128, 32, 64, 32>(lhs, rhs, scale, group_sizes, out,
                                               rows, d, f, n_groups, s);
}

}  // namespace

// C entry points (loaded with ctypes). Each returns the cudaError_t of its
// launch; cudaErrorInvalidValue for a shape the kernel does not take
// (d % 8, f % 8 for bf16 or f % 16 for int8, more than 1024 groups).
extern "C" int grouped_matmul_bf16(const void* lhs, const void* rhs,
                                   const int* group_sizes, void* out, int rows,
                                   int d, int f, int n_groups, void* stream) {
  return static_cast<int>(launch<__nv_bfloat16>(
      lhs, rhs, nullptr, group_sizes, out, rows, d, f, n_groups, stream));
}

extern "C" int grouped_matmul_int8(const void* lhs, const void* q,
                                   const float* scale, const int* group_sizes,
                                   void* out, int rows, int d, int f,
                                   int n_groups, void* stream) {
  return static_cast<int>(launch<int8_t>(lhs, q, scale, group_sizes, out, rows,
                                         d, f, n_groups, stream));
}
