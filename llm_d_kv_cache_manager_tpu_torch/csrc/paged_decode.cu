// Paged decode attention for Hopper (sm_90a), bfloat16 in, float32 math.
//
// Replaces: llm_d_kv_cache_manager_tpu/ops/paged_attention.py::_decode_kernel
// (via paged_attention, quantized=False) — batched one-token GQA attention
// over the pages block_tables[b, :] names, up to seq_lens[b], with the
// current token's K/V optionally passed separately (has_fresh).
//
// Bound on this card: HBM bandwidth. Each (sequence, kv head) reads its
// history once, hist * head_dim * 2 (K and V) * 2 bytes, and does ~4 flops
// per byte — far below the ~295 flop/byte where the tensor cores would
// limit. So the design only tries to move each byte once, in wide loads:
//   * grid (batch, n_kv): one block per (sequence, kv head); the TPU's
//     sequential page axis becomes a loop inside the block, and the block
//     reads block_tables itself;
//   * the block loads its GQA group's query rows once (one warp per query
//     head) and walks only the ceil(hist / page_size) pages it owns;
//   * each page's [page_size, head_dim] K and V slice of this head is
//     staged in shared memory with 16-byte loads — the head-minor pool
//     [L, P, ps, n_kv, hd] makes the slice strided by n_kv * hd, so it is
//     a gather of page_size rows of head_dim * 2 bytes (256 B at hd=128);
//     rows are padded by 16 B so the per-lane row reads are conflict-free;
//   * m / l / acc stay in float32 registers; the fresh token merges last;
//     seq_len == 0 rows give zeros.
// Known weakness (left for a later change): only batch * n_kv blocks run
// (64 at 8 sequences x 8 kv heads on 132 SMs) and loads are not overlapped
// with compute; a split-KV pass with cp.async/TMA pipelining is the fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Loads DPL consecutive bf16 values (DPL even) as floats.
template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < DPL / 2; ++i) {
    float2 f = __bfloat1622float2(p2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int D>
__global__ void paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, n_q, D]
    const __nv_bfloat16* __restrict__ k_pages,  // [P, ps, n_kv, D] (layer base)
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ block_tables,       // [B, max_pages]
    const int* __restrict__ seq_lens,           // [B]
    const __nv_bfloat16* __restrict__ fresh_k,  // [B, n_kv, D] or null
    const __nv_bfloat16* __restrict__ fresh_v,
    __nv_bfloat16* __restrict__ out,            // [B, n_q, D]
    int n_q, int n_kv, int page_size, int max_pages, float scale) {
  constexpr int DPL = D / 32;     // dims per lane
  constexpr int ROW = D + kPad;   // shared-memory row stride (elements)
  constexpr int CHUNKS = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + page_size * ROW;
  float* sc = reinterpret_cast<float*>(vs + page_size * ROW);  // [group][ps]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = n_q / n_kv;
  const int warp = threadIdx.x >> 5;  // query head within the group
  const int lane = threadIdx.x & 31;
  const int head = h * group + warp;
  const int seq_len = seq_lens[b];
  const bool has_fresh = fresh_k != nullptr;
  const int hist = min(has_fresh ? seq_len - 1 : seq_len, max_pages * page_size);

  float qv[DPL], acc[DPL];
  load_row<DPL>(q + ((int64_t)b * n_q + head) * D + lane * DPL, qv);
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  float* my_sc = sc + warp * page_size;

  const int64_t slot_stride = (int64_t)n_kv * D;
  const int n_pages = hist > 0 ? (hist + page_size - 1) / page_size : 0;
  for (int p = 0; p < n_pages; ++p) {
    const int64_t page = block_tables[(int64_t)b * max_pages + p];
    const int64_t base = (page * page_size * n_kv + h) * D;
    __syncthreads();  // the previous page's shared-memory reads are done
    for (int c = threadIdx.x; c < page_size * CHUNKS; c += blockDim.x) {
      const int row = c / CHUNKS;
      const int col = (c % CHUNKS) * 8;
      const int64_t g = base + row * slot_stride + col;
      *reinterpret_cast<uint4*>(ks + row * ROW + col) =
          *reinterpret_cast<const uint4*>(k_pages + g);
      *reinterpret_cast<uint4*>(vs + row * ROW + col) =
          *reinterpret_cast<const uint4*>(v_pages + g);
    }
    __syncthreads();
    const int valid = min(page_size, hist - p * page_size);
    float mcur = -INFINITY;
    for (int j = 0; j < valid; ++j) {
      float kf[DPL];
      load_row<DPL>(ks + j * ROW + lane * DPL, kf);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s += qv[i] * kf[i];
      s = warp_sum(s) * scale;
      mcur = fmaxf(mcur, s);
      if (lane == 0) my_sc[j] = s;
    }
    __syncwarp();
    const float mnew = fmaxf(m, mcur);
    const float alpha = expf(m - mnew);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    for (int j = 0; j < valid; ++j) {
      const float pj = expf(my_sc[j] - mnew);
      psum += pj;
      float vf[DPL];
      load_row<DPL>(vs + j * ROW + lane * DPL, vf);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += pj * vf[i];
    }
    __syncwarp();  // my_sc is rewritten by the next page
    l = l * alpha + psum;
    m = mnew;
  }

  if (has_fresh && seq_len > 0) {
    // The current token: a one-slot virtual page, always visible to itself.
    const int64_t off = ((int64_t)b * n_kv + h) * D + lane * DPL;
    float kf[DPL], vf[DPL];
    load_row<DPL>(fresh_k + off, kf);
    load_row<DPL>(fresh_v + off, vf);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) s += qv[i] * kf[i];
    s = warp_sum(s) * scale;
    const float mnew = fmaxf(m, s);
    const float alpha = expf(m - mnew);
    const float pf = expf(s - mnew);
    l = l * alpha + pf;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = acc[i] * alpha + pf * vf[i];
  }

  const float inv = 1.f / (l == 0.f ? 1.f : l);  // len-0 row -> zeros
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
      out + ((int64_t)b * n_q + head) * D + lane * DPL);
#pragma unroll
  for (int i = 0; i < DPL / 2; ++i)
    o2[i] = __floats2bfloat162_rn(acc[2 * i] * inv, acc[2 * i + 1] * inv);
}

template <int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* seq_lens,
                   const void* fresh_k, const void* fresh_v, void* out,
                   int batch, int n_q, int n_kv, int page_size, int max_pages,
                   int64_t layer_offset, float scale, cudaStream_t stream) {
  const int group = n_q / n_kv;
  const size_t smem = 2 * (size_t)page_size * (D + kPad) * sizeof(__nv_bfloat16) +
                      (size_t)group * page_size * sizeof(float);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k_pages) + layer_offset;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v_pages) + layer_offset;
  dim3 grid(batch, n_kv);
  paged_decode_kernel<D><<<grid, 32 * group, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kp, vp, block_tables, seq_lens,
      static_cast<const __nv_bfloat16*>(fresh_k),
      static_cast<const __nv_bfloat16*>(fresh_v),
      static_cast<__nv_bfloat16*>(out), n_q, n_kv, page_size, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). Pools are the full multi-layer
// [L, P, ps, n_kv, hd] arrays, read in place at `layer`. Returns the
// cudaError_t of the launch.
extern "C" int paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* seq_lens,
    const void* fresh_k, const void* fresh_v, void* out,
    int batch, int n_q, int n_kv, int head_dim, int page_size, int max_pages,
    int layer, int total_pages, float scale, void* stream) {
  if (batch == 0) return 0;
  const int64_t layer_offset =
      (int64_t)layer * total_pages * page_size * n_kv * head_dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // head_dim 128 only: the width of every bf16 model the port serves.
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch<128>(q, k_pages, v_pages, block_tables, seq_lens, fresh_k,
                     fresh_v, out, batch, n_q, n_kv, page_size, max_pages,
                     layer_offset, scale, s);
}
