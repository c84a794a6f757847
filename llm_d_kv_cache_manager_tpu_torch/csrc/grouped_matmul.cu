// Grouped (ragged) matmul for Hopper (sm_90a): the MoE expert FFN products.
//
//   out[r, :] = lhs[r, :] @ rhs[g(r)]          (bf16 experts, K4)
//   out[r, :] = (lhs[r, :] @ q[g(r)]) * scale[g(r), 0, :]   (int8 experts, K5)
//
// over rows sorted by expert: group g owns the rows
// [sum(group_sizes[:g]), sum(group_sizes[:g + 1])), negative sizes counting
// as 0 and the sums clamped to rows. lhs [rows, d] bf16, rhs [E, d, f] bf16
// or int8 codes with f32 scales [E, 1, f], f32 accumulation, output
// [rows, f] bf16 rounded once (K5: after the scale). Rows past the last
// group are zero. group_sizes stays on the device: nothing here
// synchronises with the host.
//
// Replaces:
//   K4  llm_d_kv_cache_manager_tpu/ops/gmm.py:115 _gmm_library (megablox gmm)
//   K5  llm_d_kv_cache_manager_tpu/ops/gmm.py:149 _int8_gmm_kernel (via _gmm_int8)
//
// What bounds them on this card, at Qwen3-30B-A3B widths (d, f) =
// (2048, 768) and (768, 2048), 128 experts, top-8:
//   * prefill (65,536 rows in ~512-row groups): operations, 2 rows d f =
//     206 GFLOP a call, 0.21 ms at 989 TFLOP/s;
//   * decode (64 rows, mostly one or two rows per expert): bytes, each
//     active expert's [d, f] slice (3.1 MB bf16, 1.6 MB int8) read once.
// The host picks the path from integers alone (ops/gmm.py
// plan_grouped_matmul): decode when rows < 16 * n_groups.
//
// Prefill path (prefill_kernel): a persistent, warp-specialised wgmma GEMM.
//   * Tiles aligned to groups: each 128-row x 256-column tile starts at
//     its group's row offset, so no two tiles share an output row (megablox
//     visits a boundary tile once per group and masks, which is safe only
//     because the TPU grid runs in order). The rows past the last group form
//     one more group whose tiles are written as zeros.
//   * One block an SM. Warp 0 scans group_sizes into shared memory once
//     (row and tile offsets), then the block walks the tile list, tile +=
//     gridDim.x. Tile t is row tile t / n_tiles, column tile t % n_tiles, so
//     the blocks running side by side share a row tile and one expert's
//     weight slice in L2.
//   * Warp roles: a producer warpgroup (one thread issues TMA, after
//     setmaxnreg down to 40) fills a ring of 128B-swizzled tiles (4 stages
//     bf16, 3 int8): A = 128 lhs rows x 64 k through a 2-D map over [rows,
//     d] (the box may start at any row; rows past `rows` arrive as TMA's
//     zero fill, rows of the next group are computed and not stored), B =
//     64 k x 256 n of the expert through a 3-D map over [E, d, f] (n
//     contiguous: MN-major, wgmma's transposed B). Full and empty mbarriers
//     per stage.
//   * Two consumer warpgroups (setmaxnreg up to 232) each run
//     wgmma.m64n256k16 (bf16 in, f32 accumulate in registers) on 64 of the
//     tile's rows, one k tile in flight behind the one being issued, and
//     free a stage as soon as its products are done. The epilogue stages
//     each warp's rows through shared memory, 64 columns at a time, so the
//     output leaves in whole 16-byte stores, rows of the tile's group only,
//     while the producer already fills the next tile's stages.
//   * K5: the codes travel by TMA as one byte each (64 x 256 int8, no
//     swizzle) beside the stage's bf16 B tile. wgmma has no bf16 x int8
//     form, so the consumers widen the next stage's codes exactly (integer
//     masks and one bf16x2 subtraction, |q| <= 128 fits bf16) into that
//     tile, in the 128B-swizzled layout TMA would have written, while the
//     current stage's products run; a named barrier joins the two
//     warpgroups' halves. The scale multiplies the f32 sum in the epilogue.
//
// Decode path (decode_kernel): stream the weights once, at the card's rate.
//   * Block (64 bf16 / 128 int8 columns of f, group g), the columns
//     fastest, so the blocks running side by side read whole rows of one
//     expert's slice (DRAM pages, not 128-byte strips of many); a block of
//     an empty group returns at once; group g = n_groups zeroes the tail.
//   * Products swapped: out^T = W^T lhs^T on mma.sync.m16n8k16, the
//     expert's f columns as the mma's 16 rows and up to 8 of the group's rows
//     as its 8 columns, so no mma row is padding. Each weight element feeds
//     exactly one thread's A fragment, so weights go from global memory
//     straight to registers (16-byte loads, 4 k steps = 256 bytes a thread in
//     flight, the first ones requested while warp 0 still finds where the
//     group starts) with no shared-memory staging; f columns are permuted so
//     that a thread's 16 bytes (8 bf16 / 16 int8 columns) at one k row feed
//     its fragments. int8 codes are widened in registers.
//   * The 8 warps of a block split d by k steps; their partial sums meet in
//     shared memory and are added in warp order: a fixed order, so two calls
//     give the same bits. A group of more than 8 rows takes 8 rows a pass.
//
// 64-bit offsets: one expert stack holds 201 M elements.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kMaxGroups = 1024;

// -- prefill path: tile shape and shared memory -----------------------------
constexpr int kTM = 128, kTN = 256, kTK = 64;
constexpr int kThreads = 384;             // 2 consumer warpgroups + 1 producer
constexpr int kABytes = kTM * kTK * 2;    // 16 KB: 128 rows x 128 B
constexpr int kAtomBytes = 64 * kTK * 2;  // 8 KB: one 64-wide n atom of B
constexpr int kBBytes = kTN / 64 * kAtomBytes;  // 32 KB: the bf16 B tile
// B's wgmma descriptor (MN-major, 128B-swizzled): bytes between its 64-wide
// n atoms (LBO) and between its 8-row k groups (SBO). The swapped pair
// fails the chip check by orders of magnitude.
constexpr int kBLbo = kAtomBytes, kBSbo = 1024;
// A consumer warp stages 16 rows x 64 columns of bf16 output at a time,
// rows 144 bytes apart (16 bytes of padding: conflict-free both ways).
constexpr int kEpiRow = 144;
constexpr int kEpiWarpBytes = 16 * kEpiRow;

// A ring stage: the lhs tile, the B tile (bf16, or int8 codes and the bf16
// tile the consumers widen them into), all 1024-byte aligned.
template <typename BT>
struct Prefill {
  static constexpr bool kQuant = sizeof(BT) == 1;
  static constexpr int kCodeBytes = kQuant ? kTK * kTN : 0;  // int8 B by TMA
  static constexpr int kStage = kABytes + kBBytes + kCodeBytes;
  static constexpr int kStages = kQuant ? 3 : 4;
  static constexpr int kTx = kABytes + (kQuant ? kCodeBytes : kBBytes);  // TMA bytes
  static constexpr int kBars = kStages * kStage;  // full, empty
  static constexpr int kEpi = kBars + 2 * kStages * 8;  // epilogue staging
  static constexpr int kTables = kEpi + 8 * kEpiWarpBytes;
  // + 1024: the dynamic base is aligned up to the swizzle atom.
  static constexpr int kSmem = 1024 + kTables + 2 * (kMaxGroups + 2) * 4;
};
static_assert(Prefill<bf16>::kSmem <= 232448 && Prefill<int8_t>::kSmem <= 232448, "smem");

// -- decode path --------------------------------------------------------------
constexpr int kDecWarps = 8;
constexpr int kDecUnroll = 4;  // k steps a warp loads before it multiplies

template <typename BT>
struct Decode {
  static constexpr int kPerThread = 16 / sizeof(BT);  // f columns a thread
  static constexpr int kWidth = 8 * kPerThread;       // f columns a block
  static constexpr int kTiles = kPerThread / 2;       // 16-row mma tiles a thread
};

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Warp 0: row_off[g] = first row of group g (g = n_groups: the tail, which
// ends at rows), clamped to rows; tile_off[g] = first row tile of group g.
__device__ void scan_groups(const int* __restrict__ group_sizes, int n_groups, int rows,
                            int* row_off, int* tile_off, int lane) {
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
  const int g1 = n_groups + 1;
  per = (g1 + 31) / 32;
  lo = min(lane * per, g1);
  hi = min(lo + per, g1);
  int t = 0;
  for (int g = lo; g < hi; ++g) t += (row_off[g + 1] - row_off[g] + kTM - 1) / kTM;
  const int tinc = warp_inclusive_scan(t, lane);
  int toff = tinc - t;
  for (int g = lo; g < hi; ++g) {
    tile_off[g] = toff;
    toff += (row_off[g + 1] - row_off[g] + kTM - 1) / kTM;
  }
  if (lane == 31) tile_off[g1] = tinc;
}

struct Tile {
  int g, r0, r1, n0;
};

// Tile `tile` of the walk: its group (n_groups for the zero tail), rows
// [r0, r1) and first column.
__device__ __forceinline__ Tile locate(int tile, int n_tiles, const int* row_off,
                                       const int* tile_off, int n_groups) {
  const int rt = tile / n_tiles;
  int lo = 0, hi = n_groups + 1;  // largest g with tile_off[g] <= rt
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_off[mid] <= rt) lo = mid; else hi = mid;
  }
  Tile t;
  t.g = lo;
  t.r0 = row_off[lo] + (rt - tile_off[lo]) * kTM;
  t.r1 = min(t.r0 + kTM, row_off[lo + 1]);
  t.n0 = (tile % n_tiles) * kTN;
  return t;
}

// Four int8 codes of w (two's complement) as bf16 pairs lo = {c0, c1},
// hi = {c2, c3}, exactly, with no float conversion: each code's low 7 bits
// become the mantissa of 128 + low7 and its sign bit the exponent step of
// 128 + 128 s (bf16 0x4300 / 0x4380); one bf16x2 subtraction leaves
// low7 - 128 s, whose at most 8 significant bits bf16 holds.
__device__ __forceinline__ void i8x4_to_bf16(unsigned w, unsigned& lo, unsigned& hi) {
  const unsigned o = w >> 8;
  __nv_bfloat162 x, y;
  unsigned e_lo = (w & 0x007F007Fu) | 0x43004300u, e_hi = (w & 0x00800080u) | 0x43004300u;
  unsigned o_lo = (o & 0x007F007Fu) | 0x43004300u, o_hi = (o & 0x00800080u) | 0x43004300u;
  x = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&e_lo), *reinterpret_cast<__nv_bfloat162*>(&e_hi));
  y = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&o_lo), *reinterpret_cast<__nv_bfloat162*>(&o_hi));
  const unsigned e = *reinterpret_cast<unsigned*>(&x);  // c0, c2
  const unsigned od = *reinterpret_cast<unsigned*>(&y); // c1, c3
  lo = __byte_perm(e, od, 0x5410);
  hi = __byte_perm(e, od, 0x7632);
}

// 16 codes (one 16-byte chunk) to 16 bf16 in two 16-byte halves, exactly.
__device__ __forceinline__ void i8x16_to_bf16(const uint4& c, uint4& lo, uint4& hi) {
  i8x4_to_bf16(c.x, lo.x, lo.y);
  i8x4_to_bf16(c.y, lo.z, lo.w);
  i8x4_to_bf16(c.z, hi.x, hi.y);
  i8x4_to_bf16(c.w, hi.z, hi.w);
}

template <typename BT>
__global__ void __launch_bounds__(kThreads, 1)
prefill_kernel(const __grid_constant__ CUtensorMap tm_lhs,  // [rows, d] bf16
               const __grid_constant__ CUtensorMap tm_rhs,  // [E, d, f]
               const float* __restrict__ scale,             // [E, 1, f] (K5)
               const int* __restrict__ group_sizes,         // [E]
               bf16* __restrict__ out,                      // [rows, f]
               int rows, int d, int f, int n_groups) {
  using P = Prefill<BT>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);  // TMA landed
  uint64_t* empty = full + S;  // both warpgroups' products are done
  int* row_off = reinterpret_cast<int*>(smem + P::kTables);
  int* tile_off = row_off + kMaxGroups + 2;
  auto a_tile = [&](int s) { return smem + s * P::kStage; };
  auto b_tile = [&](int s) { return smem + s * P::kStage + kABytes; };
  auto code_tile = [&](int s) { return smem + s * P::kStage + kABytes + kBBytes; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  if (tid < 32) scan_groups(group_sizes, n_groups, rows, row_off, tile_off, tid);
  __syncthreads();

  const int n_tiles = (f + kTN - 1) / kTN;
  const int total = tile_off[n_groups + 1] * n_tiles;
  const int k_tiles = (d + kTK - 1) / kTK;

  if (tid >= 256) {
    // Producer warpgroup: one thread keeps the ring full.
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const Tile t = locate(tile, n_tiles, row_off, tile_off, n_groups);
        if (t.g == n_groups) continue;  // zero tail: nothing to load
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&full[s], P::kTx);
          tma_load_2d(a_tile(s), &tm_lhs, &full[s], kt * kTK, t.r0);
          if constexpr (P::kQuant) {
            tma_load_3d(code_tile(s), &tm_rhs, &full[s], t.n0, kt * kTK, t.g);
          } else {
#pragma unroll
            for (int q = 0; q < kTN / 64; ++q)
              tma_load_3d(b_tile(s) + q * kAtomBytes, &tm_rhs, &full[s], t.n0 + 64 * q,
                          kt * kTK, t.g);
          }
          if (++s == S) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // Consumer warpgroups: rows 64 wg .. 64 wg + 63 of each tile.
    setmaxnreg_inc<232>();
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int gq = lane >> 2, tq = lane & 3;
    // K5: wait for stage s, widen this thread's share of its 64 x 256 codes
    // into the stage's bf16 B tile (four 64-wide n atoms in the
    // 128B-swizzled layout TMA would have written: 16-byte chunk c of row k
    // at chunk c ^ (k % 8)), then meet the other warpgroup. Each 8 threads
    // (one shared-memory phase of 16-byte accesses) take 4 code chunks of
    // row k in atom a and 4 of row k + 1 in atom a ^ 1: their loads cover
    // all 32 banks, and their stores 8 distinct swizzled chunks.
    auto widen = [&](int s, uint32_t ph) {
      mbar_wait(&full[s], ph);
      const unsigned char* src = code_tile(s);
      unsigned char* dst = b_tile(s);
#pragma unroll
      for (int q = 0; q < kTK * kTN / 16 / 256; ++q) {
        const int i = tid + 256 * q, odd = (i >> 2) & 1;
        const int k = 2 * (i >> 5) + odd, c16 = 4 * (((i >> 3) & 3) ^ odd) + (i & 3);
        uint4 lo, hi;
        i8x16_to_bf16(*reinterpret_cast<const uint4*>(src + k * kTN + c16 * 16), lo, hi);
        unsigned char* row = dst + (c16 >> 2) * kAtomBytes + k * 128;
        const int c = (c16 & 3) * 2;
        *reinterpret_cast<uint4*>(row + ((c ^ (k & 7)) << 4)) = lo;
        *reinterpret_cast<uint4*>(row + (((c + 1) ^ (k & 7)) << 4)) = hi;
      }
      fence_proxy_async();
      named_barrier(1, 256);
    };
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const Tile t = locate(tile, n_tiles, row_off, tile_off, n_groups);
      const int m0 = t.r0 + 64 * wg;
      if (t.g == n_groups) {  // rows past the last group: zeros
        const int cols = min(kTN, f - t.n0);
        for (int c = tid % 128; c < 64 * (kTN / 8); c += 128) {
          const int r = m0 + c / (kTN / 8), n = (c % (kTN / 8)) * 8;
          if (r < t.r1 && n < cols)
            *reinterpret_cast<uint4*>(out + (int64_t)r * f + t.n0 + n) = make_uint4(0, 0, 0, 0);
        }
        continue;
      }
      if constexpr (P::kQuant) widen(s, ph);
      for (int kt = 0; kt < k_tiles; ++kt) {
        if constexpr (!P::kQuant) mbar_wait(&full[s], ph);
        fence_regs<128>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTK / 16; ++kk)
          wgmma_m64n256k16_bf16<1>(acc, wgmma_desc(a_tile(s) + wg * 8192 + kk * 32, 16, 1024),
                                   wgmma_desc(b_tile(s) + kk * 16 * 128, kBLbo, kBSbo),
                                   kt > 0 || kk > 0);
        wgmma_commit();
        fence_regs<128>(acc);
        wgmma_wait<1>();  // the previous step's products are done: free its stage
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        const int s1 = s + 1 == S ? 0 : s + 1;
        const uint32_t ph1 = s1 == 0 ? ph ^ 1 : ph;
        // K5: the next stage's codes are widened while these products run
        // (and the freed stage refills).
        if constexpr (P::kQuant) {
          if (kt + 1 < k_tiles) widen(s1, ph1);
        }
        prev = s;
        s = s1;
        ph = ph1;
      }
      wgmma_wait<0>();
      fence_regs<128>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      // Epilogue: per-column scale (K5), one rounding to bf16, staged 64
      // columns at a time through the warp's shared buffer so that each
      // row's 128 bytes go out in whole 16-byte stores; rows of this
      // tile's group only.
      unsigned char* ebuf = smem + P::kEpi + (tid / 32) * kEpiWarpBytes;
      const int rw = m0 + 16 * warp;  // the warp's first row
#pragma unroll
      for (int c = 0; c < kTN / 64; ++c) {
        if (t.n0 + 64 * c >= f) break;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * c + jj, col = t.n0 + 8 * j + 2 * tq;
          float s0 = 1.f, s1 = 1.f;
          if constexpr (P::kQuant) {
            if (col < f) {
              const float2 sc = *reinterpret_cast<const float2*>(scale + (int64_t)t.g * f + col);
              s0 = sc.x;
              s1 = sc.y;
            }
          }
          *reinterpret_cast<unsigned*>(ebuf + gq * kEpiRow + jj * 16 + tq * 4) =
              pack_bf16x2(acc[4 * j] * s0, acc[4 * j + 1] * s1);
          *reinterpret_cast<unsigned*>(ebuf + (gq + 8) * kEpiRow + jj * 16 + tq * 4) =
              pack_bf16x2(acc[4 * j + 2] * s0, acc[4 * j + 3] * s1);
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = (lane + 32 * q) >> 3, c16 = lane & 7;
          const int r = rw + row, col = t.n0 + 64 * c + 8 * c16;
          if (r < t.r1 && col < f)
            *reinterpret_cast<uint4*>(out + (int64_t)r * f + col) =
                *reinterpret_cast<const uint4*>(ebuf + row * kEpiRow + c16 * 16);
        }
        __syncwarp();
      }
    }
  }
}

// The A fragment of mma tile j (rows: f columns fb + 2j, fb + 2j + 1 of the
// thread's chunk) at one k step, from the thread's 16 bytes at k rows 2t,
// 2t + 1, 2t + 8, 2t + 9 (w[0..3]).
template <typename BT>
__device__ __forceinline__ void decode_frag(const uint4* w, int j, unsigned* a);

template <>
__device__ __forceinline__ void decode_frag<bf16>(const uint4* w, int j, unsigned* a) {
  // Word j of a row holds columns 2j (low half) and 2j + 1 (high half).
  const unsigned* w0 = &w[0].x;
  const unsigned* w1 = &w[1].x;
  const unsigned* w2 = &w[2].x;
  const unsigned* w3 = &w[3].x;
  a[0] = __byte_perm(w0[j], w1[j], 0x5410);  // column 2j,     k 2t, 2t + 1
  a[1] = __byte_perm(w0[j], w1[j], 0x7632);  // column 2j + 1, k 2t, 2t + 1
  a[2] = __byte_perm(w2[j], w3[j], 0x5410);  // column 2j,     k 2t + 8, 2t + 9
  a[3] = __byte_perm(w2[j], w3[j], 0x7632);
}

template <>
__device__ __forceinline__ void decode_frag<int8_t>(const uint4* w, int j, unsigned* a) {
  // Word j / 2 of a row holds columns 4 (j / 2) .. + 3, one byte each:
  // gather bytes (2j, 2j + 1) % 4 of two rows as [r0.b, r1.b, r0.b+1, r1.b+1].
  const unsigned sel = (j & 1) ? 0x7362u : 0x5140u;
  i8x4_to_bf16(__byte_perm((&w[0].x)[j >> 1], (&w[1].x)[j >> 1], sel), a[0], a[1]);
  i8x4_to_bf16(__byte_perm((&w[2].x)[j >> 1], (&w[3].x)[j >> 1], sel), a[2], a[3]);
}

template <typename BT>
__global__ void __launch_bounds__(32 * kDecWarps)
decode_kernel(const bf16* __restrict__ lhs,           // [rows, d]
              const BT* __restrict__ rhs,             // [E, d, f]
              const float* __restrict__ scale,        // [E, 1, f] (K5)
              const int* __restrict__ group_sizes,    // [E]
              bf16* __restrict__ out,                 // [rows, f]
              int rows, int d, int f, int n_groups) {
  using D = Decode<BT>;
  constexpr int W = D::kWidth;
  __shared__ float red[kDecWarps][8][W];  // each warp's partial out^T
  __shared__ int span[2];

  const int g = blockIdx.y, f0 = blockIdx.x * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cols = min(W, f - f0);
  const int gq = lane >> 2, tq = lane & 3;
  const int fl = gq * D::kPerThread;  // the thread's first column in the block
  const bool f_ok = fl < cols;
  const BT* wbase = rhs + (int64_t)g * d * f + f0 + fl;
  const int k_steps = (d + 15) / 16;
  // The thread's weights of k steps kb .. kb + kDecUnroll - 1 (rows 2t,
  // 2t + 1, 2t + 8, 2t + 9 of each), zero past d.
  uint4 w[kDecUnroll][4];
  auto load_w = [&](int kb) {
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = (kb + u) * 16 + 2 * tq + (q & 1) + (q >> 1) * 8;
        w[u][q] = f_ok && k < d ? __ldg(reinterpret_cast<const uint4*>(wbase + (int64_t)k * f))
                                : make_uint4(0, 0, 0, 0);
      }
  };
  // The group's own size decides at once whether the block has work; its
  // first weights are then in flight while warp 0 finds where it starts.
  if (g < n_groups) {
    if (group_sizes[g] <= 0) return;
    load_w(warp * kDecUnroll);
  }
  if (warp == 0) {  // this group's rows [start, end), clamped as the scan does
    long long s = 0;
    for (int i = 4 * lane; i < g; i += 128) {  // 16-byte loads: 128 sizes a pass
      int v[4];
      if (i + 3 < n_groups) {
        const int4 x = *reinterpret_cast<const int4*>(group_sizes + i);
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = i + e < n_groups ? group_sizes[i + e] : 0;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s += i + e < g ? max(v[e], 0) : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      span[0] = (int)min(s, (long long)rows);
      span[1] = g < n_groups ? (int)min(s + max(group_sizes[g], 0), (long long)rows) : rows;
    }
  }
  __syncthreads();
  const int start = span[0], end = span[1];
  if (start >= end) return;
  if (g == n_groups) {  // rows past the last group: zeros
    for (int c = tid; c < (end - start) * (W / 8); c += 32 * kDecWarps) {
      const int r = start + c / (W / 8), n = (c % (W / 8)) * 8;
      if (n < cols)
        *reinterpret_cast<uint4*>(out + (int64_t)r * f + f0 + n) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  for (int r0 = start; r0 < end; r0 += 8) {
    const int row = r0 + gq;  // the thread's B column: row `row` of lhs
    const bf16* lrow = lhs + (int64_t)min(row, end - 1) * d;
    float acc[D::kTiles][4];
#pragma unroll
    for (int j = 0; j < D::kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int kb = warp * kDecUnroll; kb < k_steps; kb += kDecWarps * kDecUnroll) {
      if (r0 != start || kb != warp * kDecUnroll) load_w(kb);  // else already in flight
      unsigned b[kDecUnroll][2];
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        const int k0 = (kb + u) * 16 + 2 * tq;
        b[u][0] = row < end && k0 < d ? *reinterpret_cast<const unsigned*>(lrow + k0) : 0u;
        b[u][1] = row < end && k0 + 8 < d ? *reinterpret_cast<const unsigned*>(lrow + k0 + 8) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u)
#pragma unroll
        for (int j = 0; j < D::kTiles; ++j) {
          unsigned a[4];
          decode_frag<BT>(w[u], j, a);
          mma_bf16(acc[j], a, b[u]);
        }
    }
    // acc[j] = out^T rows (columns fl + 2j, fl + 2j + 1) x lhs rows (2t, 2t + 1).
#pragma unroll
    for (int j = 0; j < D::kTiles; ++j) {
      red[warp][2 * tq][fl + 2 * j] = acc[j][0];
      red[warp][2 * tq + 1][fl + 2 * j] = acc[j][1];
      red[warp][2 * tq][fl + 2 * j + 1] = acc[j][2];
      red[warp][2 * tq + 1][fl + 2 * j + 1] = acc[j][3];
    }
    __syncthreads();
    // The warps' partial sums, added in warp order; scale (K5), one rounding.
    for (int p = tid; p < 8 * W / 2; p += 32 * kDecWarps) {
      const int n = p / (W / 2), c = (p % (W / 2)) * 2;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int v = 0; v < kDecWarps; ++v) {
        s0 += red[v][n][c];
        s1 += red[v][n][c + 1];
      }
      if (r0 + n < end && c < cols) {
        if constexpr (sizeof(BT) == 1) {
          const float2 sc = *reinterpret_cast<const float2*>(scale + (int64_t)g * f + f0 + c);
          s0 *= sc.x;
          s1 *= sc.y;
        }
        *reinterpret_cast<unsigned*>(out + (int64_t)(r0 + n) * f + f0 + c) = pack_bf16x2(s0, s1);
      }
    }
    __syncthreads();
  }
}

// -- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (the library links no libcuda); null where it is not found.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major tensor of `rank` dims (innermost first), `elem` bytes an
// element, tiled by `box`; zero fill outside it.
bool tensor_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                const cuuint32_t* box, int elem, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[2] = {dims[0] * elem, dims[0] * dims[1] * elem};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                rank, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename BT>
cudaError_t launch_prefill(const void* lhs, const void* rhs, const float* scale,
                           const int* group_sizes, void* out, int rows, int d, int f,
                           int n_groups, int blocks, cudaStream_t stream) {
  constexpr int smem = Prefill<BT>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tm_lhs, tm_rhs;
  const cuuint64_t lhs_dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint32_t lhs_box[2] = {kTK, kTM};
  const cuuint64_t rhs_dims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)n_groups};
  const cuuint32_t rhs_box[3] = {Prefill<BT>::kQuant ? (cuuint32_t)kTN : 64u, kTK, 1};
  if (!tensor_map(&tm_lhs, lhs, 2, lhs_dims, lhs_box, 2, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tm_rhs, rhs, 3, rhs_dims, rhs_box, sizeof(BT),
                  Prefill<BT>::kQuant ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  prefill_kernel<BT><<<blocks, kThreads, smem, stream>>>(
      tm_lhs, tm_rhs, scale, group_sizes, static_cast<bf16*>(out), rows, d, f, n_groups);
  return cudaGetLastError();
}

template <typename BT>
cudaError_t launch(const void* lhs, const void* rhs, const float* scale,
                   const int* group_sizes, void* out, int rows, int d, int f, int n_groups,
                   int path, int grid_x, int grid_y, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (n_groups < 1 || n_groups > kMaxGroups || d < 1 || d % 8 != 0 || f < 1 ||
      f % (16 / (int)sizeof(BT)) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {  // prefill: persistent blocks
    if (grid_x < 1 || grid_y != 1) return cudaErrorInvalidValue;
    return launch_prefill<BT>(lhs, rhs, scale, group_sizes, out, rows, d, f, n_groups,
                              grid_x, s);
  }
  constexpr int W = Decode<BT>::kWidth;
  if (path != 1 || grid_x != (f + W - 1) / W || grid_y != n_groups + 1)
    return cudaErrorInvalidValue;
  decode_kernel<BT><<<dim3(grid_x, grid_y), 32 * kDecWarps, 0, s>>>(
      static_cast<const bf16*>(lhs), static_cast<const BT*>(rhs), scale, group_sizes,
      static_cast<bf16*>(out), rows, d, f, n_groups);
  return cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes). `path` and the grid come from
// ops/gmm.py plan_grouped_matmul: path 0 (prefill) launches grid_x
// persistent blocks; path 1 (decode) takes grid (ceil(f / 64) bf16 or
// ceil(f / 128) int8, n_groups + 1). Each returns the cudaError_t of its launch
// (or of the shared-memory attribute call before it);
// cudaErrorInvalidValue for a shape or grid the kernels do not take (d % 8,
// f % 8 for bf16 or f % 16 for int8, more than 1024 groups) or a tensor map
// cuTensorMapEncodeTiled refuses.
extern "C" int grouped_matmul_bf16(const void* lhs, const void* rhs, const int* group_sizes,
                                   void* out, int rows, int d, int f, int n_groups, int path,
                                   int grid_x, int grid_y, void* stream) {
  return static_cast<int>(launch<bf16>(lhs, rhs, nullptr, group_sizes, out, rows, d, f,
                                       n_groups, path, grid_x, grid_y, stream));
}

extern "C" int grouped_matmul_int8(const void* lhs, const void* q, const float* scale,
                                   const int* group_sizes, void* out, int rows, int d, int f,
                                   int n_groups, int path, int grid_x, int grid_y,
                                   void* stream) {
  return static_cast<int>(launch<int8_t>(lhs, q, scale, group_sizes, out, rows, d, f,
                                         n_groups, path, grid_x, grid_y, stream));
}
