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
// 989 TFLOP/s.
//
// Design (simple and right; speed is for later):
//   * One block per (64 f columns, 64 d rows, group): the columns fastest.
//     The TPU kernel walks groups in order in one grid dimension and keeps
//     its sum in scratch across steps; here every output tile belongs to
//     one group and one block, so nothing carries between blocks and no
//     atomics are needed. Warp 0 finds the group's rows from an exclusive
//     prefix sum of group_sizes (at most a few hundred ints).
//   * The block loops over the group's rows 32 at a time: a two-stage
//     cp.async ring stages 32 rows x 64 d of lhs and 32 rows x 64 f of dout
//     in shared memory (rows of 144 bytes, so ldmatrix is free of bank
//     conflicts); rows past the group arrive as zero fill.
//   * mma.sync.m16n8k16 with the group's rows as the contraction: lhs^T is
//     the A operand (ldmatrix.trans of the [row][d] tile), dout the B
//     operand (ldmatrix.trans of the [row][f] tile). Four warps, each 16 d
//     rows x 64 f columns, 32 f32 accumulators a thread.
//   * Sums run in row order, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;         // output tile: 64 d rows x 64 f columns
constexpr int kChunk = 32;     // group rows a ring stage (two mma k steps)
constexpr int kThreads = 128;  // 4 warps, 16 d rows each
constexpr int kRow = 72;       // shared row stride in bf16 (144 bytes)
constexpr int kMaxGridZ = 65535;

__global__ void __launch_bounds__(kThreads)
tgmm_kernel(const bf16* __restrict__ lhs,        // [rows, d]
            const bf16* __restrict__ dout,       // [rows, f]
            const int* __restrict__ group_sizes,  // [E]
            bf16* __restrict__ out,              // [E, d, f]
            int rows, int d, int f) {
  __shared__ __align__(128) bf16 sa[2][kChunk][kRow];  // lhs rows: [row][d]
  __shared__ __align__(128) bf16 sb[2][kChunk][kRow];  // dout rows: [row][f]
  __shared__ int span[2];

  const int g = blockIdx.z;
  const int f0 = blockIdx.x * kT, d0 = blockIdx.y * kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (warp == 0) {
    long long s = 0;
    for (int i = lane; i < g; i += 32) s += max(group_sizes[i], 0);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const long long start = min(s, (long long)rows);
      span[0] = (int)start;
      span[1] = (int)min(start + max(group_sizes[g], 0), (long long)rows);
    }
  }
  __syncthreads();
  const int start = span[0], end = span[1];
  const int n_chunks = (end - start + kChunk - 1) / kChunk;

  // A stage: kChunk rows x 64 columns of each operand, 16 bytes a copy
  // (d % 8 == 0 and f % 8 == 0, so a copy is wholly inside or outside).
  auto load = [&](int c, int buf) {
    for (int i = tid; i < kChunk * 8; i += kThreads) {
      const int r = i >> 3, col = (i & 7) * 8;
      const int row = start + c * kChunk + r;
      const bool a_in = row < end && d0 + col < d;
      const bool b_in = row < end && f0 + col < f;
      cp_async16(&sa[buf][r][col], a_in ? lhs + (size_t)row * d + d0 + col : lhs, a_in);
      cp_async16(&sb[buf][r][col], b_in ? dout + (size_t)row * f + f0 + col : dout, b_in);
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix addressing: lane i gives row i & 7 of 8x8 matrix i >> 3.
  const int mat = lane >> 3, mrow = lane & 7;
  if (n_chunks > 0) load(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) {
      load(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 16) {
      // A[m = d][k = row] = sa[row][d]: matrix j holds rows k + 8 (j >> 1),
      // columns m + 8 (j & 1), transposed on load.
      unsigned a[4];
      ldsm_x4_trans(a, &sa[buf][ks + (mat >> 1) * 8 + mrow][warp * 16 + (mat & 1) * 8]);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        // B[k = row][n = f] = sb[row][f]: matrices (k 0-7, n), (k 8-15, n),
        // (k 0-7, n + 8), (k 8-15, n + 8), transposed on load.
        unsigned b[4];
        ldsm_x4_trans(b, &sb[buf][ks + (mat & 1) * 8 + mrow][n * 8 + (mat >> 1) * 8]);
        mma_bf16(acc[n], a, b);
        mma_bf16(acc[n + 1], a, b + 2);
      }
    }
    __syncthreads();
  }

  // c fragments: lane 4 gid + t holds (d row gid, f columns 2t, 2t + 1) and
  // (d row gid + 8, the same columns) of each 16 x 8 tile.
  const int gid = lane >> 2, t = lane & 3;
  bf16* o = out + (size_t)g * d * f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = f0 + n * 8 + 2 * t;
    if (col >= f) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = d0 + warp * 16 + gid + h * 8;
      if (row < d)
        *reinterpret_cast<unsigned*>(o + (size_t)row * f + col) =
            pack_bf16x2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes): grid (ceil(f / 64), ceil(d / 64),
// n_groups), 128 threads. Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a shape it does not take (d or f not a positive
// multiple of 8, n_groups outside 1..65535).
extern "C" int grouped_matmul_tgmm(const void* lhs, const void* dout, const int* group_sizes,
                                   void* out, int rows, int d, int f, int n_groups,
                                   void* stream) {
  if (rows < 0 || d < 8 || d % 8 != 0 || f < 8 || f % 8 != 0 || n_groups < 1 ||
      n_groups > kMaxGridZ)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((f + kT - 1) / kT, (d + kT - 1) / kT, n_groups);
  tgmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout), group_sizes,
      static_cast<bf16*>(out), rows, d, f);
  return static_cast<int>(cudaGetLastError());
}
