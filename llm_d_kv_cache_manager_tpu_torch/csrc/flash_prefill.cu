// Flash prefill over [paged context ++ fresh causal chunk] for Hopper
// (sm_90a), bfloat16 in, float32 accumulation, on the tensor cores.
//
// Replaces: llm_d_kv_cache_manager_tpu/ops/flash_prefill.py::
// _flash_prefill_kernel (via flash_prefill_paged, ctx_mode="gather"), and
// computes the function of its page-direct variant _flash_prefill_kernel_dma
// as well: context K/V are read straight from the page pool through the
// block table — no gathered [b, n_kv, ctx, hd] buffer is ever built.
//
// Bound on this card: at serving chunk sizes the work is
// 4 * n_q * hd * n_valid * (ctx + (n_valid + 1) / 2) flops per sequence
// against one read of q/k/v/context and one write of the output, far above
// the ~295 flop/byte ridge: tensor-core throughput bounds it. The design
// (FlashAttention-2 on mma.sync; wgmma with TMA-fed tiles is the next step):
//   * grid (b, n_kv, q_blocks); a block owns 64 score rows = the GQA group's
//     query heads x (64 / group) consecutive query tokens, as the JAX kernel
//     collapses query rows x group into one row dimension; each of its 4
//     warps owns 16 rows, one mma row tile, so group 4 and group 8 both fill
//     a fragment;
//   * tiles 0 .. n_ctx-1 walk the context in 64-key tiles up to ctx_len,
//     each key's page resolved from the block's own block_tables row; the
//     rest walk the chunk's key tiles up to the causal frontier of the
//     block's last valid row and n_valid;
//   * K/V tiles arrive through a two-stage cp.async ring (rows padded by
//     16 B, so ldmatrix phases are conflict-free): the next tile is in
//     flight while the current one is computed, one barrier per tile; keys
//     past ctx_len / n_valid are zero-filled, never read. Each tile's key
//     offsets (its pages read from the block's own block_tables row) are
//     resolved one tile earlier still, into shared memory, so the table
//     read's latency hides behind a tile's compute. Q is staged in the ring's
//     second stage before the loop, which keeps a block at 69 KB; two
//     blocks an SM (__launch_bounds__ min 2) leave each thread the ~200
//     registers its Q, S and O fragments need without spilling;
//   * S = Q K^T and O += P V on mma.sync.m16n8k16 (bf16 in, f32
//     accumulate); Q's fragments stay in registers for the whole loop; the S
//     accumulator is rounded to bf16 in place and reused as the A operand of
//     P V (no shared-memory round trip) — probabilities rounded to bf16
//     before p @ v, as the JAX kernel casts them to the V dtype;
//   * online softmax in float32 with the finite -1e30 mask and a mask
//     multiply (flash_prefill.py:105-122), so a fully padded row yields
//     exact zeros, never NaN; l sums the float32 probabilities. Scores are
//     kept in base 2 (scale * log2 e folded in, exp2), and tiles that no
//     mask reaches (every row valid, every key visible) skip the masking.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // score rows per block (query tokens x group)
constexpr int kKeys = 64;      // keys per tile
constexpr int kWarps = kRows / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;     // cp.async ring depth
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRows <= kKeys, "Q is staged in one K tile of the ring");

template <int D>
constexpr int smem_bytes() {
  return 2 * kStages * kKeys * (D + 8) * (int)sizeof(bf16) + 2 * kKeys * (int)sizeof(int64_t);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_prefill_kernel(
    const bf16* __restrict__ q,        // [b, s, n_q, D]
    const bf16* __restrict__ k,        // [b, s, n_kv, D]
    const bf16* __restrict__ v,
    const bf16* __restrict__ k_pages,  // [P, ps, n_kv, D]
    const bf16* __restrict__ v_pages,
    const int* __restrict__ block_tables,  // [b, ctx_pages]
    const int* __restrict__ ctx_lens,      // [b]
    const int* __restrict__ n_valid,       // [b]
    bf16* __restrict__ out,                // [b, s, n_q, D]
    int s, int n_q, int n_kv, int page_size, int ctx_pages, float scale) {
  constexpr int LD = D + 8;       // padded shared-memory row (elements)
  constexpr int CH = D / 8;       // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;  // mma k-steps over head_dim
  constexpr int NT = kKeys / 8;   // score n-tiles per warp
  constexpr int DT = D / 8;       // output n-tiles per warp
  constexpr int TILE = kKeys * LD;
  static_assert(NT <= 8, "the per-thread key mask is 32 bits");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kStages][kKeys][LD]
  bf16* vs = ks + kStages * TILE;
  bf16* qs = ks + TILE;  // [kRows][LD], in stage 1 until tile 1 is loaded
  int64_t* koff = reinterpret_cast<int64_t*>(vs + kStages * TILE);  // [2][kKeys]

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = n_q / n_kv;
  const int bq = kRows / group;  // query tokens per block
  const int q0 = blockIdx.z * bq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ctx_len = min(ctx_lens[b], ctx_pages * page_size);
  const int nv = min(n_valid[b], s);
  const int64_t kv_row = (int64_t)n_kv * D;  // stride between tokens / slots
  const int q_last = min(q0 + bq, nv) - 1;   // last valid query of the block
  const float scale2 = scale * kLog2e;       // scores in base 2
  const int n_ctx = (ctx_len + kKeys - 1) / kKeys;
  const int n_tiles = q_last >= q0 ? n_ctx + q_last / kKeys + 1 : 0;

  // Row r <-> token q0 + r / group, head h * group + r % group.
  auto out_row = [&](int r) {
    return out + (((int64_t)b * s + q0 + r / group) * n_q + h * group + r % group) * D;
  };

  if (n_tiles == 0) {  // every row of the block is padding: zeros
    for (int c = tid; c < kRows * CH; c += kThreads) {
      const int r = c / CH;
      if (q0 + r / group < s)
        *reinterpret_cast<uint4*>(out_row(r) + (c % CH) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  // Query tile (rows past s zero-filled), in the same copy group as tile 0.
  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const int qi = q0 + r / group;
    const bool ok = qi < s;
    cp_async16(qs + r * LD + col,
               ok ? q + (((int64_t)b * s + qi) * n_q + h * group + r % group) * D + col : q, ok);
  }

  // Key `tid` of tile `it` (threads tid < kKeys): fetch_key reads what the
  // block table says of it (its page; 0 for a chunk key; -1 past ctx_len /
  // n_valid), key_offset turns that into its element offset in the pool or
  // the chunk (-1: zero-filled), kept in koff[it & 1].
  auto fetch_key = [&](int it) -> int {
    if (it < n_ctx) {
      const int t = it * kKeys + tid;
      return t < ctx_len ? block_tables[(int64_t)b * ctx_pages + t / page_size] : -1;
    }
    return (it - n_ctx) * kKeys + tid < nv ? 0 : -1;
  };
  auto key_offset = [&](int it, int page) -> int64_t {
    if (page < 0) return -1;
    const int t = (it < n_ctx ? it : it - n_ctx) * kKeys + tid;
    const int64_t slot = it < n_ctx ? (int64_t)page * page_size + t % page_size
                                    : (int64_t)b * s + t;
    return slot * kv_row + (int64_t)h * D;
  };
  // One K/V tile into ring stage `stage` from its offsets in koff: 16-byte
  // copies, each thread the same column of rows tid / CH + (kThreads / CH) i.
  auto load_tile = [&](int it, int stage) {
    const bf16* kbase = it < n_ctx ? k_pages : k;
    const bf16* vbase = it < n_ctx ? v_pages : v;
    const int64_t* offs = koff + (it & 1) * kKeys;
    bf16* kd = ks + stage * TILE;
    bf16* vd = vs + stage * TILE;
    const int col = (tid % CH) * 8;
#pragma unroll
    for (int i = 0; i < kKeys / (kThreads / CH); ++i) {
      const int r = tid / CH + i * (kThreads / CH);
      const int64_t off = offs[r];
      const bool ok = off >= 0;
      cp_async16(kd + r * LD + col, kbase + (ok ? off : 0) + col, ok);
      cp_async16(vd + r * LD + col, vbase + (ok ? off : 0) + col, ok);
    }
  };

  if (tid < kKeys) koff[tid] = key_offset(0, fetch_key(0));
  __syncthreads();
  load_tile(0, 0);
  cp_async_commit();
  if (tid < kKeys && n_tiles > 1) koff[kKeys + tid] = key_offset(1, fetch_key(1));
  cp_async_wait<0>();
  __syncthreads();

  // This warp's query fragments, held for the whole loop.
  unsigned qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  __syncthreads();  // every warp has its Q: stage 1 may take tile 1

  // This thread's two rows: g and g + 8 of the warp's 16.
  const int g = lane >> 2, tq = lane & 3;
  int rpos[2];
  bool rok[2];
  float m[2], l[2], o[DT][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rpos[hr] = q0 + (warp * 16 + g + 8 * hr) / group;
    rok[hr] = rpos[hr] < nv;
    m[hr] = kNegInf;
    l[hr] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it > 0) {
      cp_async_wait<0>();  // tile `it` has landed
      __syncthreads();     // ... for every thread; tile it-1 is consumed
    }
    if (it + 1 < n_tiles) {
      load_tile(it + 1, (it + 1) & 1);  // in flight during this tile
      cp_async_commit();
    }
    // The table read for tile it + 2, in flight during this tile's compute.
    const bool fetch = tid < kKeys && it + 2 < n_tiles;
    const int fetched = fetch ? fetch_key(it + 2) : -1;
    const bool ctx = it < n_ctx;
    const int t0 = (ctx ? it : it - n_ctx) * kKeys;
    const bf16* kt = ks + (it & 1) * TILE;
    const bf16* vt = vs + (it & 1) * TILE;

    // S = Q K^T: K rows are keys, contiguous along D, i.e. K^T column-major.
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned r[4];
        ldsm_x4(r, kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * jp], qf[kk], r);
        mma_bf16(sc[2 * jp + 1], qf[kk], r + 2);
      }

    // Mask (bit j * 4 + e for sc[j][e]), unless no mask reaches the tile:
    // every row of the block valid and every key visible to every row.
    const bool open = q0 + bq <= nv &&
                      (ctx ? t0 + kKeys <= ctx_len : t0 + kKeys - 1 <= q0 && t0 + kKeys <= nv);
    unsigned okm = ~0u;
    if (open) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= scale2;
    } else {
      okm = 0u;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int t = t0 + j * 8 + 2 * tq + (e & 1);
          const bool ok = rok[hr] && (ctx ? t < ctx_len : (t <= rpos[hr] && t < nv));
          okm |= (ok ? 1u : 0u) << (j * 4 + e);
          sc[j][e] = ok ? sc[j][e] * scale2 : kNegInf;
        }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) mt = fmaxf(mt, fmaxf(sc[j][2 * hr], sc[j][2 * hr + 1]));
      // The row's 4 lanes (same g) hold its 64 keys.
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mnew = fmaxf(m[hr], mt);
      const float alpha = exp2f(m[hr] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          // The mask multiply (not the -1e30 alone) zeroes masked keys: on a
          // fully masked row mnew == -1e30 and exp2(0) == 1.
          const float p = exp2f(sc[j][e] - mnew) * ((okm >> (j * 4 + e)) & 1u ? 1.f : 0.f);
          rs += p;
          sc[j][e] = p;
        }
      l[hr] = l[hr] * alpha + rs;  // this thread's share; summed over the quad at the end
      m[hr] = mnew;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][2 * hr] *= alpha;
        o[n][2 * hr + 1] *= alpha;
      }
    }

    // O += P V: the S fragments, rounded to bf16, are P's A fragments.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        unsigned r[4];
        ldsm_x4_trans(r, vt + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa, r);
        mma_bf16(o[2 * np + 1], pa, r + 2);
      }
    }
    // Buffer it & 1 was last read by tile it's copies, before this
    // iteration's barrier.
    if (fetch) koff[(it & 1) * kKeys + tid] = key_offset(it + 2, fetched);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lsum = l[hr];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int r = warp * 16 + g + 8 * hr;
    if (q0 + r / group >= s) continue;
    const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);  // masked row -> zeros
    bf16* dst = out_row(r) + 2 * tq;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<unsigned*>(dst + n * 8) =
          pack_bf16x2(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* ctx_lens,
                   const int* n_valid, void* out, int b, int s, int n_q,
                   int n_kv, int page_size, int ctx_pages, float scale,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  // Above 48 KB a block's dynamic shared memory must be asked for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int bq = kRows / (n_q / n_kv);
  dim3 grid(b, n_kv, (s + bq - 1) / bq);
  flash_prefill_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), block_tables, ctx_lens, n_valid,
      static_cast<bf16*>(out), s, n_q, n_kv, page_size, ctx_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). Pools are one layer's
// [P, ps, n_kv, hd] arrays. Returns the cudaError_t of the launch (or of
// the shared-memory attribute call before it).
extern "C" int flash_prefill_bf16(
    const void* q, const void* k, const void* v, const void* k_pages,
    const void* v_pages, const int* block_tables, const int* ctx_lens,
    const int* n_valid, void* out, int b, int s, int n_q, int n_kv,
    int head_dim, int page_size, int ctx_pages, float scale, void* stream) {
  if (b == 0 || s == 0) return 0;
  // head_dim 128 only: the width of every bf16 model the port serves; the
  // GQA group must divide the 64 rows of a block.
  if (head_dim != 128 || n_kv <= 0 || n_q % n_kv != 0 || kRows % (n_q / n_kv) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<128>(
      q, k, v, k_pages, v_pages, block_tables, ctx_lens, n_valid, out, b, s,
      n_q, n_kv, page_size, ctx_pages, scale, static_cast<cudaStream_t>(stream)));
}
