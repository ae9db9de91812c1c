// Tensor-core building blocks of the port's implicit-GEMM kernels
// (conv3d_tc.cu, upconv_tc.cu): cp.async copies into shared memory with
// zero-fill, ldmatrix fragment loads and mma.sync.m16n8k16 bf16 -> f32.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ctunet {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) from global memory into shared memory; when !valid the
// source is not read and the destination is zero-filled (src-size 0).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* s, bool lo_ok,
                                            bool hi_ok) {
  const uint32_t lo = lo_ok ? __ldg(s) : 0u;
  const uint32_t hi = hi_ok ? __ldg(s + 1) : 0u;
  return lo | hi << 16;
}

// The B fragments of NF n8 tiles for one k16 step from shared memory laid
// out [k-group of 8][n][8]: brow is the byte address of k-group (2*ks +
// (lane >> 3 & 1)) at n = 0, bn the row count of one k-group.
template <int NF>
__device__ __forceinline__ void load_b(uint32_t (&b)[NF][2], uint32_t brow,
                                       int lane) {
  if constexpr (NF == 1) {
    ldsm_x2(b[0], brow + 16u * (lane & 7));
  } else {
    const int b_row = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
    for (int j = 0; j < NF / 2; ++j) {
      uint32_t r[4];
      ldsm_x4(r, brow + 16u * static_cast<uint32_t>(j * 16 + b_row));
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
  }
}

}  // namespace ctunet
