// Warp-level building blocks shared by the kernels (flash_prefill.cu,
// paged_decode.cu, grouped_matmul.cu): asynchronous global -> shared copies
// (cp.async), ldmatrix, and the bf16 m16n8k16 tensor-core product with
// float32 accumulation. ops/_build.py hashes this header into the digest of
// each library whose source includes it, so an edit here rebuilds those.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the destination is
// zero-filled (and nothing is read) when !pred. `src` must still be a
// valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane i addresses one row
// (lanes 8m .. 8m+7 the rows of matrix m).
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
// Fragments: lane = 4 g + t holds a {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)}, b {(k 2t..2t+1, n g), (k 2t+8.., n g)} and c {(g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The transpose of an 8x8 b16 matrix held one fragment row pair a lane
// (lane 4g + t: row g, columns 2t, 2t+1), in the same layout.
__device__ __forceinline__ unsigned movmatrix_trans(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// Two floats rounded to bf16 and packed into 32 bits (low = first).
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

}  // namespace sm90
