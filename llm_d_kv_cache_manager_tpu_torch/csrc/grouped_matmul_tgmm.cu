// Transposed grouped matmul for Hopper (sm_90a): the expert-weight gradient
// of the MoE expert FFN products (K6).
//
//   drhs[g] = lhs[rows_g]^T @ dout[rows_g]          [E, d, f]
//
// over rows sorted by expert: group g owns the rows
// [sum(group_sizes[:g]), sum(group_sizes[:g + 1])), negative sizes counting
// as 0 and the sums clamped to rows (as K4, csrc/grouped_matmul.cu). lhs
// [rows, d] bf16, dout [rows, f] bf16, f32 accumulation, output rounded once
// to bf16. An empty group's slice is zeros; rows past the last group add
// nothing. group_sizes stays on the device: nothing here synchronises with
// the host.
//
// Replaces: megablox tgmm (jax/experimental/pallas/ops/tpu/megablox/ops.py:90,
// pallas_call at megablox/gmm.py:763), reached from the backward of
// llm_d_kv_cache_manager_tpu/ops/gmm.py:115 _gmm_library (megablox gmm's
// custom_vjp, megablox/ops.py:22).
//
// What bounds it on this card, at Qwen3-30B-A3B training widths (16,384
// rows over 128 experts; (d, f) = (2048, 768) and (768, 2048)): bytes, the
// [E, d, f] stack written once (403 MB) beside both operands read once
// (92 MB), 0.148 ms at 3.35 TB/s; the products are 51.5 GFLOP, 0.052 ms at
// 989 TFLOP/s. The stores are 81 % of the bytes, so the design keeps them
// streaming while everything else runs behind them.
//
// Design: a persistent, warp-specialised wgmma GEMM whose contraction is
// the group's rows.
//   * One block an SM walks a flat list of output tiles, tile += gridDim.x.
//     Tile t is (group, 128 d rows, 256 f columns), the group outermost, so
//     the blocks running side by side read one group's rows (a few hundred
//     KB) through L2 and each operand leaves device memory about once. A
//     block's group never decreases along its walk, so each thread keeps a
//     running row offset and adds the sizes it passes: O(E) reads a block,
//     no table, any number of groups. Each output element is summed by one
//     block in row order, with no split of the rows and no atomics, so two
//     calls give the same bits.
//   * A producer warp (one thread issues TMA, after setmaxnreg down to 40)
//     fills a 3-stage ring: per stage 64 rows of the group, as two 64 d x
//     64 row boxes of lhs and four 64 f x 64 row boxes of dout, 128B
//     swizzled, each starting at the group's row (a TMA box may start at
//     any row). lhs^T is wgmma's A and dout its B, both MN-major (d and f
//     contiguous), the transposed forms wgmma reads from shared memory. A
//     box wholly past d or f is not loaded: it feeds only outputs the
//     stores clip.
//   * Two consumer warpgroups (setmaxnreg up to 232) each run
//     wgmma.m64n256k16 on 64 of the tile's d rows, one k tile in flight
//     behind the one being issued, and free a stage as soon as its products
//     are done.
//   * The last k tile of a group holds rows of the next groups (or TMA's
//     zero fill past `rows`): the consumers zero those rows in both
//     operands' boxes before the products, so no value of a neighbouring
//     group, NaN included, reaches the sums. A row of an MN-major 128B-
//     swizzled box is one whole 128-byte line, whatever the swizzle;
//     fence.proxy.async and a named barrier make the writes visible to
//     wgmma, which reads through the async proxy.
//   * Epilogue: each warpgroup rounds its accumulators once to bf16 into
//     its 32 KB staging tile, in the 128B-swizzled layout (the fragment
//     writes are free of bank conflicts), and one thread sends it out by
//     TMA store, four 64 x 64 boxes whose d and f edges the tensor map
//     clips, and goes on: the stores drain while the next tile's products
//     run and the producer refills the ring. The staging tile is rewritten
//     only once its last store has read it. An empty group's tiles load
//     nothing and store zeros.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kTM = 128;      // d rows a tile: 64 a consumer warpgroup
constexpr int kTN = 256;      // f columns a tile
constexpr int kTK = 64;       // group rows a k tile
constexpr int kStages = 3;
constexpr int kThreads = 384; // 2 consumer warpgroups + 1 producer
constexpr int kBox = 64 * 128;               // 8 KB: 64 rows of 128-byte lines
constexpr int kABytes = kTM / 64 * kBox;     // 16 KB of lhs a stage
constexpr int kStage = kABytes + kTN / 64 * kBox;  // + 32 KB of dout
constexpr int kOutBytes = kTN / 64 * kBox;   // a warpgroup's staging tile
constexpr int kOut = kStages * kStage;       // staging tiles
constexpr int kBars = kOut + 2 * kOutBytes;  // full, empty
// + 1024: the dynamic base is aligned up to the swizzle atom.
constexpr int kSmem = 1024 + kBars + 2 * kStages * 8;
static_assert(kSmem <= 232448, "smem");
constexpr int kMaxGroups = 65535;

// The first row of group g, walked forward from the last group a thread
// asked for (g never decreases).
struct GroupWalk {
  const int* sizes;
  int g;
  long long start;  // sum of max(size, 0) over the groups before g
  __device__ __forceinline__ void to(int target) {
    for (; g < target; ++g) start += max(__ldg(sizes + g), 0);
  }
};

struct Tile {
  int g, d0, f0, r0, r1;  // group, first d row, first f column, rows [r0, r1)
};

// Tile `tile` of the walk: group outermost, then d tiles, f tiles fastest;
// the group's rows clamped to `rows` as K4 clamps them.
__device__ __forceinline__ Tile tile_at(long long tile, int n_d, int n_f, GroupWalk& walk,
                                        int rows) {
  const long long per_group = (long long)n_d * n_f;
  Tile t;
  t.g = (int)(tile / per_group);
  const int rem = (int)(tile - t.g * per_group);
  t.d0 = rem / n_f * kTM;
  t.f0 = rem % n_f * kTN;
  walk.to(t.g);
  t.r0 = (int)min(walk.start, (long long)rows);
  t.r1 = (int)min(walk.start + max(__ldg(walk.sizes + t.g), 0), (long long)rows);
  return t;
}

__global__ void __launch_bounds__(kThreads, 1)
tgmm_kernel(const __grid_constant__ CUtensorMap tm_lhs,   // [rows, d] bf16
            const __grid_constant__ CUtensorMap tm_dout,  // [rows, f] bf16
            const __grid_constant__ CUtensorMap tm_out,   // [E, d, f] bf16
            const int* __restrict__ group_sizes,          // [E]
            int rows, int d, int f, int n_groups) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);  // TMA landed
  uint64_t* empty = full + kStages;  // both warpgroups' products are done
  // Box b of stage s: b = 0, 1 the lhs boxes (d rows d0 .. + 63, + 64 ..),
  // b = 2 .. 5 the dout boxes (f columns f0 + 64 (b - 2) ..).
  auto box = [&](int s, int b) { return smem + s * kStage + b * kBox; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int n_d = (d + kTM - 1) / kTM, n_f = (f + kTN - 1) / kTN;
  const long long total = (long long)n_groups * n_d * n_f;
  GroupWalk walk{group_sizes, 0, 0};

  if (tid >= 256) {
    // Producer warpgroup: one thread keeps the ring full.
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const Tile t = tile_at(tile, n_d, n_f, walk, rows);
        const int na = min(kTM / 64, (d - t.d0 + 63) / 64);  // boxes inside d
        const int nb = min(kTN / 64, (f - t.f0 + 63) / 64);  // and inside f
        for (int r = t.r0; r < t.r1; r += kTK) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&full[s], (na + nb) * kBox);
          for (int h = 0; h < na; ++h)
            tma_load_2d(box(s, h), &tm_lhs, &full[s], t.d0 + 64 * h, r);
          for (int q = 0; q < nb; ++q)
            tma_load_2d(box(s, 2 + q), &tm_dout, &full[s], t.f0 + 64 * q, r);
          if (++s == kStages) { s = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // Consumer warpgroups: d rows d0 + 64 wg .. + 63 of each tile.
  setmaxnreg_inc<232>();
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  unsigned char* staging = smem + kOut + wg * kOutBytes;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const Tile t = tile_at(tile, n_d, n_f, walk, rows);
    const int n = t.r1 - t.r0;
    if (n <= 0) {  // an empty group: zeros
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    }
    for (int k0 = 0; k0 < n; k0 += kTK) {
      mbar_wait(&full[s], ph);
      const int valid = n - k0;
      if (valid < kTK) {
        // Rows valid .. 63 of the six boxes lie past the group: zero those
        // 128-byte lines, 16 bytes a store.
        const int per_box = (kTK - valid) * 8;
        for (int i = tid; i < 6 * per_box; i += 256) {
          const int b = i / per_box, c = i - b * per_box;
          *reinterpret_cast<uint4*>(box(s, b) + valid * 128 + c * 16) = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_barrier(1, 256);
      }
      fence_regs<128>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)  // a k16 step is 16 rows: 2048 bytes
        wgmma_m64n256k16_bf16<1, 1>(acc, wgmma_desc(box(s, wg) + kk * 2048, kBox, 1024),
                                    wgmma_desc(box(s, 2) + kk * 2048, kBox, 1024),
                                    k0 > 0 || kk > 0);
      wgmma_commit();
      fence_regs<128>(acc);
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (k0 > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == kStages) { s = 0; ph ^= 1; }
    }
    if (n > 0) {
      wgmma_wait<0>();
      fence_regs<128>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    // Epilogue: once the last store has read the staging tile, write this
    // tile's bf16 values into it as TMA's 128B swizzle lays a 64 x 64 box
    // (16-byte chunk c of row r at chunk c ^ (r % 8); the warp's rows
    // 16 warp + gq and + 8 are both gq mod 8), then store it.
    const bool issuer = tid % 128 == 0;
    if (issuer) bulk_wait_read<0>();
    named_barrier(2 + wg, 128);
    const int row = 16 * warp + gq;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      unsigned char* line = staging + (j >> 3) * kBox + row * 128 + (((j & 7) ^ gq) << 4) + tq * 4;
      *reinterpret_cast<unsigned*>(line) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<unsigned*>(line + 8 * 128) = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (issuer) {
      const int dr = t.d0 + 64 * wg;
      if (dr < d)
        for (int q = 0; q < kTN / 64 && t.f0 + 64 * q < f; ++q)
          tma_store_3d(&tm_out, staging + q * kBox, t.f0 + 64 * q, dr, t.g);
      bulk_commit();
    }
  }
  if (tid % 128 == 0) bulk_wait<0>();
}

}  // namespace

// C entry point (loaded with ctypes): grid_x persistent blocks of 384
// threads (ops/gmm.py plan_grouped_matmul_tgmm: min(tiles, SMs)). Returns
// the cudaError_t of the launch (or of the shared-memory attribute call
// before it); cudaErrorInvalidValue for a shape it does not take (rows < 1:
// the wrapper fills the zeros itself; d or f not a positive multiple of 8;
// n_groups outside 1..65535; grid_x < 1) or a tensor map
// cuTensorMapEncodeTiled refuses.
extern "C" int grouped_matmul_tgmm(const void* lhs, const void* dout, const int* group_sizes,
                                   void* out, int rows, int d, int f, int n_groups, int grid_x,
                                   void* stream) {
  if (rows < 1 || d < 8 || d % 8 != 0 || f < 8 || f % 8 != 0 || n_groups < 1 ||
      n_groups > kMaxGroups || grid_x < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr =
      cudaFuncSetAttribute(tgmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tm_lhs, tm_dout, tm_out;
  const cuuint64_t lhs_dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t dout_dims[2] = {(cuuint64_t)f, (cuuint64_t)rows};
  const cuuint64_t out_dims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)n_groups};
  const cuuint32_t box[3] = {64, 64, 1};
  if (!tensor_map(&tm_lhs, lhs, 2, lhs_dims, box, 2, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tm_dout, dout, 2, dout_dims, box, 2, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tm_out, out, 3, out_dims, box, 2, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  tgmm_kernel<<<grid_x, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_lhs, tm_dout, tm_out, group_sizes, rows, d, f, n_groups);
  return static_cast<int>(cudaGetLastError());
}
