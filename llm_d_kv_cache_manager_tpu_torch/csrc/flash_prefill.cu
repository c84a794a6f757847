// Flash prefill over [paged context ++ fresh causal chunk] for Hopper
// (sm_90a), bfloat16 in, float32 accumulation.
//
// Replaces: llm_d_kv_cache_manager_tpu/ops/flash_prefill.py::
// _flash_prefill_kernel (via flash_prefill_paged, ctx_mode="gather"), and
// computes the function of its page-direct variant _flash_prefill_kernel_dma
// as well: context K/V are read straight from the page pool through the
// block table — no gathered [b, n_kv, ctx, hd] buffer is ever built.
//
// Bound on this card: at serving chunk sizes the work is
// 4 * n_q * hd * n_valid * (ctx + (n_valid + 1) / 2) flops per sequence
// against one read of q/k/v/context and one write of the output, i.e. far
// above the ~295 flop/byte ridge: tensor-core throughput bounds it. This
// first version runs its products on the CUDA cores in float32 FMAs (the
// tensor-core path — wgmma with TMA-fed tiles — is later work), so its own
// ceiling is the 67 TFLOP/s float32 rate; the design keeps those FMAs fed:
//   * grid (b, n_kv, q_blocks); a block owns 64 score rows = the GQA group's
//     query heads x (64 / group) consecutive query tokens, as the JAX kernel
//     collapses query rows x group into one row dimension;
//   * loop 1 walks the context in 32-key tiles up to ctx_len, resolving each
//     key's page from the block table; loop 2 walks the chunk's key tiles up
//     to the causal frontier of the block's last valid row and n_valid;
//   * Q, K and V tiles live in shared memory (rows padded by 16 B, 16-byte
//     accesses, conflict-free); each thread owns a 4 x 4 score sub-tile and
//     4 rows x hd/8 output columns of the float32 accumulator in registers;
//   * online softmax in float32 with the finite -1e30 mask and a mask
//     multiply (flash_prefill.py:105-122), so a fully padded row yields
//     zeros, never NaN; probabilities are rounded to bfloat16 before p @ v,
//     as the JAX kernel casts them to the V dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // score rows per block (query tokens x group)
constexpr int kKeys = 32;     // keys per tile
constexpr int kThreads = 128; // 16 row groups of 4 x 8 key/column lanes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,        // [b, s, n_q, D]
    const __nv_bfloat16* __restrict__ k,        // [b, s, n_kv, D]
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ k_pages,  // [P, ps, n_kv, D]
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ block_tables,       // [b, ctx_pages]
    const int* __restrict__ ctx_lens,           // [b]
    const int* __restrict__ n_valid,            // [b]
    __nv_bfloat16* __restrict__ out,            // [b, s, n_q, D]
    int s, int n_q, int n_kv, int page_size, int ctx_pages, float scale) {
  constexpr int ROW = D + 8;   // padded shared-memory row (elements)
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int NC = D / 64;   // 8-column groups each thread owns in p @ v
  __shared__ __align__(16) __nv_bfloat16 qs[kRows * ROW];
  __shared__ __align__(16) __nv_bfloat16 ks[kKeys * ROW];
  __shared__ __align__(16) __nv_bfloat16 vs[kKeys * ROW];
  __shared__ float ps[kRows * (kKeys + 1)];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = n_q / n_kv;
  const int bq = kRows / group;  // query tokens per block
  const int q0 = blockIdx.z * bq;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // keys tx + 8j; columns c*64 + tx*8 .. +7
  const int ctx_len = min(ctx_lens[b], ctx_pages * page_size);
  const int nv = min(n_valid[b], s);
  const int64_t kv_row = (int64_t)n_kv * D;  // stride between tokens / slots

  // Query tile: row r <-> token q0 + r / group, head h * group + r % group.
  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const int qi = q0 + r / group;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qi < s)
      val = *reinterpret_cast<const uint4*>(
          q + (((int64_t)b * s + qi) * n_q + h * group + r % group) * D + col);
    *reinterpret_cast<uint4*>(qs + r * ROW + col) = val;
  }

  int rpos[4];
  bool rok[4];
  float m[4], l[4], acc[4][NC * 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rpos[i] = q0 + (ty * 4 + i) / group;
    rok[i] = rpos[i] < nv;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 8; ++c) acc[i][c] = 0.f;
  }
  const int q_last = min(q0 + bq, nv) - 1;  // last valid query of the block

  // Tiles 0 .. n_ctx-1 walk the cached context page by page through the
  // block table (every key < ctx_len is visible); the rest walk the chunk's
  // own keys up to the causal frontier of the block's last valid row.
  const int n_ctx = (ctx_len + kKeys - 1) / kKeys;
  const int n_tiles = q_last >= q0 ? n_ctx + q_last / kKeys + 1 : 0;
  for (int it = 0; it < n_tiles; ++it) {
    const bool ctx = it < n_ctx;
    const int t0 = (ctx ? it : it - n_ctx) * kKeys;
    __syncthreads();  // previous tile's ks / vs / ps reads are done
    for (int c = tid; c < kKeys * CH; c += kThreads) {
      const int kk = c / CH, col = (c % CH) * 8;
      const int t = t0 + kk;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (ctx && t < ctx_len) {
        const int64_t page = block_tables[(int64_t)b * ctx_pages + t / page_size];
        const int64_t off = (page * page_size + t % page_size) * kv_row + (int64_t)h * D + col;
        kv = *reinterpret_cast<const uint4*>(k_pages + off);
        vv = *reinterpret_cast<const uint4*>(v_pages + off);
      } else if (!ctx && t < nv) {
        const int64_t off = ((int64_t)b * s + t) * kv_row + (int64_t)h * D + col;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + kk * ROW + col) = kv;
      *reinterpret_cast<uint4*>(vs + kk * ROW + col) = vv;
    }
    __syncthreads();

    // Scores: this thread's rows ty*4+i against keys tx+8j.
    float sv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sv[i][j] = 0.f;
#pragma unroll 2
    for (int dc = 0; dc < D; dc += 8) {
      float qf[4][8], kf[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        unpack8(*reinterpret_cast<const uint4*>(qs + (ty * 4 + i) * ROW + dc), qf[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        unpack8(*reinterpret_cast<const uint4*>(ks + (tx + 8 * j) * ROW + dc), kf[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e) sv[i][j] += qf[i][e] * kf[j][e];
    }

    // Online-softmax update per row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mk[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + tx + 8 * j;
        const bool ok = rok[i] && (ctx ? t < ctx_len : (t <= rpos[i] && t < nv));
        mk[j] = ok ? 1.f : 0.f;
        sv[i][j] = ok ? sv[i][j] * scale : kNegInf;
        mt = fmaxf(mt, sv[i][j]);
      }
      // The row's 8 key lanes are lanes tx = 0..7 of one warp.
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mnew = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sv[i][j] - mnew) * mk[j];
        rs += p;
        ps[(ty * 4 + i) * (kKeys + 1) + tx + 8 * j] =
            __bfloat162float(__float2bfloat16_rn(p));
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < NC * 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // ps complete

    // acc += p @ v over the tile's keys.
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty * 4 + i) * (kKeys + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vf[8];
        unpack8(*reinterpret_cast<const uint4*>(vs + kk * ROW + c * 64 + tx * 8), vf);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][c * 8 + e] += pr[i] * vf[e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = q0 + r / group;
    if (qi >= s) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);  // masked row -> zeros
    __nv_bfloat16* o = out + (((int64_t)b * s + qi) * n_q + h * group + r % group) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint4 packed;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p2[e] = __floats2bfloat162_rn(acc[i][c * 8 + 2 * e] * inv,
                                      acc[i][c * 8 + 2 * e + 1] * inv);
      *reinterpret_cast<uint4*>(o + c * 64 + tx * 8) = packed;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* ctx_lens,
                   const int* n_valid, void* out, int b, int s, int n_q,
                   int n_kv, int page_size, int ctx_pages, float scale,
                   cudaStream_t stream) {
  const int bq = kRows / (n_q / n_kv);
  dim3 grid(b, n_kv, (s + bq - 1) / bq);
  flash_prefill_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), block_tables, ctx_lens,
      n_valid, static_cast<__nv_bfloat16*>(out), s, n_q, n_kv, page_size,
      ctx_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). Pools are one layer's
// [P, ps, n_kv, hd] arrays. Returns the cudaError_t of the launch.
extern "C" int flash_prefill_bf16(
    const void* q, const void* k, const void* v, const void* k_pages,
    const void* v_pages, const int* block_tables, const int* ctx_lens,
    const int* n_valid, void* out, int b, int s, int n_q, int n_kv,
    int head_dim, int page_size, int ctx_pages, float scale, void* stream) {
  if (b == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // head_dim 128 only: the width of every bf16 model the port serves.
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch<128>(q, k, v, k_pages, v_pages, block_tables, ctx_lens,
                     n_valid, out, b, s, n_q, n_kv, page_size, ctx_pages,
                     scale, st);
}
