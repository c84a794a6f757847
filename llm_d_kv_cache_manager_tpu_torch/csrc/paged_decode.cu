// Paged decode attention for Hopper (sm_90a), float32 math, in two entries:
//
//   paged_decode_bf16  (K1) replaces llm_d_kv_cache_manager_tpu/ops/
//     paged_attention.py::_decode_kernel with quantized=False: bfloat16 pools;
//   paged_decode_int8  (K1q) replaces the same kernel with quantized=True
//     (KV_QUANT_HBM=int8): int8 code pools plus one f32 scale per page per
//     (layer, kv head), [L, P, n_kv], fetched through the same block-table
//     index as the page; the codes are dequantized in registers
//     (code * scale in float32, as the JAX kernel and the plain version do)
//     and the fresh token stays bfloat16.
//
// Both compute batched one-token GQA attention over the pages
// block_tables[b, :] names, up to seq_lens[b], with the current token's K/V
// optionally passed separately (has_fresh); a seq_len == 0 row gives zeros.
//
// Bound on this card: HBM bandwidth. Each (sequence, kv head) reads its
// history once, hist * head_dim * 2 (K and V) * 2 bytes (bf16) or * 1 byte
// (int8, plus 8 bytes of scales a page), and does ~4 flops per byte (8 for
// int8) — far below the ~295 flop/byte where the tensor cores would limit.
// So the design only tries to move each byte once, in wide loads:
//   * grid (batch, n_kv): one block per (sequence, kv head); the TPU's
//     sequential page axis becomes a loop inside the block, and the block
//     reads block_tables itself;
//   * the block loads its GQA group's query rows once (one warp per query
//     head) and walks only the ceil(hist / page_size) pages it owns;
//   * each page's [page_size, head_dim] K and V slice of this head is
//     staged in shared memory with 16-byte loads (8 bf16 values or 16 int8
//     codes) — the head-minor pool [L, P, ps, n_kv, hd] makes the slice
//     strided by n_kv * hd, so it is a gather of page_size rows of
//     head_dim * sizeof(element) bytes; rows are padded by 16 B so the
//     per-lane row reads are conflict-free;
//   * m / l / acc stay in float32 registers; the fresh token merges last.
// Known weakness (left for a later change): only batch * n_kv blocks run
// (64 at 8 sequences x 8 kv heads on 132 SMs) and loads are not overlapped
// with compute; a split-KV pass with cp.async/TMA pipelining is the fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPadBytes = 16;  // padding per shared-memory row

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Loads DPL consecutive bf16 values (DPL even) as floats; `scale` is unused
// (bf16 pools carry no scales).
template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out,
                                         float /*scale*/) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < DPL / 2; ++i) {
    float2 f = __bfloat1622float2(p2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Loads DPL consecutive int8 codes (DPL a multiple of 4) dequantized to
// float32 as code * scale.
template <int DPL>
__device__ __forceinline__ void load_row(const int8_t* p, float* out,
                                         float scale) {
  const char4* p4 = reinterpret_cast<const char4*>(p);
#pragma unroll
  for (int i = 0; i < DPL / 4; ++i) {
    const char4 c = p4[i];
    out[4 * i] = static_cast<float>(c.x) * scale;
    out[4 * i + 1] = static_cast<float>(c.y) * scale;
    out[4 * i + 2] = static_cast<float>(c.z) * scale;
    out[4 * i + 3] = static_cast<float>(c.w) * scale;
  }
}

template <int D, typename T>
__global__ void paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, n_q, D]
    const T* __restrict__ k_pages,              // [P, ps, n_kv, D] (layer base)
    const T* __restrict__ v_pages,
    const float* __restrict__ k_scale,          // [P, n_kv] (layer base) or null
    const float* __restrict__ v_scale,
    const int* __restrict__ block_tables,       // [B, max_pages]
    const int* __restrict__ seq_lens,           // [B]
    const __nv_bfloat16* __restrict__ fresh_k,  // [B, n_kv, D] or null
    const __nv_bfloat16* __restrict__ fresh_v,
    __nv_bfloat16* __restrict__ out,            // [B, n_q, D]
    int n_q, int n_kv, int page_size, int max_pages, float scale) {
  constexpr int DPL = D / 32;                              // dims per lane
  constexpr int ROW = D * (int)sizeof(T) + kPadBytes;      // smem row bytes
  constexpr int EPC = 16 / (int)sizeof(T);                 // elements per 16 B
  constexpr int CHUNKS = D / EPC;                          // 16 B chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = smem_raw;
  unsigned char* vs = ks + page_size * ROW;
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
  load_row<DPL>(q + ((int64_t)b * n_q + head) * D + lane * DPL, qv, 1.f);
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  float* my_sc = sc + warp * page_size;

  const int64_t slot_stride = (int64_t)n_kv * D;
  const int n_pages = hist > 0 ? (hist + page_size - 1) / page_size : 0;
  for (int p = 0; p < n_pages; ++p) {
    const int64_t page = block_tables[(int64_t)b * max_pages + p];
    const int64_t base = (page * page_size * n_kv + h) * D;
    // The page's (layer, kv head) scales; 1 (unused) for bf16 pools.
    const float sk = k_scale != nullptr ? k_scale[page * n_kv + h] : 1.f;
    const float sv = v_scale != nullptr ? v_scale[page * n_kv + h] : 1.f;
    __syncthreads();  // the previous page's shared-memory reads are done
    for (int c = threadIdx.x; c < page_size * CHUNKS; c += blockDim.x) {
      const int row = c / CHUNKS;
      const int col = (c % CHUNKS) * EPC;
      const int64_t g = base + row * slot_stride + col;
      *reinterpret_cast<uint4*>(ks + row * ROW + col * (int)sizeof(T)) =
          *reinterpret_cast<const uint4*>(k_pages + g);
      *reinterpret_cast<uint4*>(vs + row * ROW + col * (int)sizeof(T)) =
          *reinterpret_cast<const uint4*>(v_pages + g);
    }
    __syncthreads();
    const int valid = min(page_size, hist - p * page_size);
    float mcur = -INFINITY;
    for (int j = 0; j < valid; ++j) {
      float kf[DPL];
      load_row<DPL>(reinterpret_cast<const T*>(ks + j * ROW) + lane * DPL, kf, sk);
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
      load_row<DPL>(reinterpret_cast<const T*>(vs + j * ROW) + lane * DPL, vf, sv);
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
    load_row<DPL>(fresh_k + off, kf, 1.f);
    load_row<DPL>(fresh_v + off, vf, 1.f);
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

template <int D, typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* v_scale,
                   const int* block_tables, const int* seq_lens,
                   const void* fresh_k, const void* fresh_v, void* out,
                   int batch, int n_q, int n_kv, int page_size, int max_pages,
                   int layer, int total_pages, float scale, cudaStream_t stream) {
  const int group = n_q / n_kv;
  const size_t smem = 2 * (size_t)page_size * (D * sizeof(T) + kPadBytes) +
                      (size_t)group * page_size * sizeof(float);
  const int64_t layer_offset = (int64_t)layer * total_pages * page_size * n_kv * D;
  const int64_t scale_offset = (int64_t)layer * total_pages * n_kv;
  const T* kp = static_cast<const T*>(k_pages) + layer_offset;
  const T* vp = static_cast<const T*>(v_pages) + layer_offset;
  dim3 grid(batch, n_kv);
  paged_decode_kernel<D, T><<<grid, 32 * group, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kp, vp,
      k_scale != nullptr ? k_scale + scale_offset : nullptr,
      v_scale != nullptr ? v_scale + scale_offset : nullptr,
      block_tables, seq_lens,
      static_cast<const __nv_bfloat16*>(fresh_k),
      static_cast<const __nv_bfloat16*>(fresh_v),
      static_cast<__nv_bfloat16*>(out), n_q, n_kv, page_size, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry points (loaded with ctypes). Pools are the full multi-layer
// [L, P, ps, n_kv, hd] arrays (scales [L, P, n_kv]), read in place at
// `layer`. head_dim 128 only: the width of every model the port serves.
// Each returns the cudaError_t of the launch.
extern "C" int paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* seq_lens,
    const void* fresh_k, const void* fresh_v, void* out,
    int batch, int n_q, int n_kv, int head_dim, int page_size, int max_pages,
    int layer, int total_pages, float scale, void* stream) {
  if (batch == 0) return 0;
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch<128, __nv_bfloat16>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, seq_lens, fresh_k,
      fresh_v, out, batch, n_q, n_kv, page_size, max_pages, layer, total_pages,
      scale, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_decode_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale,
    const int* block_tables, const int* seq_lens,
    const void* fresh_k, const void* fresh_v, void* out,
    int batch, int n_q, int n_kv, int head_dim, int page_size, int max_pages,
    int layer, int total_pages, float scale, void* stream) {
  if (batch == 0) return 0;
  if (head_dim != 128 || k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<128, int8_t>(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, seq_lens, fresh_k,
      fresh_v, out, batch, n_q, n_kv, page_size, max_pages, layer, total_pages,
      scale, static_cast<cudaStream_t>(stream));
}
