// Tensor-core building blocks of the port's implicit-GEMM kernels
// (conv3d_tc.cu, upconv_tc.cu, their int8 forms conv3d_tc_q.cu,
// upconv_tc_q.cu, and the f32 conv3d_tc_f32.cu): cp.async copies into
// shared memory with zero-fill, ldmatrix fragment loads,
// mma.sync.m16n8k16 bf16 -> f32, mma.sync.m16n8k32 s8 -> s32, and
// mma.sync.m16n8k8 tf32 -> f32 with the split of an f32 value into two
// tf32 halves that split-tf32 (3xTF32) products are built from.
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

// The int8 product: A 16x32 and B 32x8 bytes, int32 sums. A 16-byte
// ldmatrix row holds 16 int8 values of K where it holds 8 bf16 ones, so
// the fragments load exactly as mma_bf16's do: ldsm_x4 on four 8x16-byte
// tiles (rows 0-7 / 8-15, bytes 0-15 / 16-31 of K) for A, and load_b on
// [n][16 bytes] rows for B (bytes 0-15, then 16-31).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tf32 product: A 16x8 and B 8x8 tf32 values (the .b32 words of f32
// values rounded to tf32), f32 sums. A 16-byte ldmatrix row holds 4 f32
// values of K where it holds 8 bf16 ones, so the fragments load exactly as
// mma_bf16's do: ldsm_x4 on four 8x16-byte tiles (rows 0-7 / 8-15, words
// 0-3 / 4-7 of K) gives a0..a3, and load_b on [n][4 f32] rows gives b0, b1.
// The tensor cores truncate their f32 sums (round toward zero), so a long
// sum kept in the accumulator drifts toward zero; conv3d_tc_f32.cu takes
// each product into a zeroed fragment and adds it up with ordinary
// round-to-nearest FADDs.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same product into a fresh fragment: d = A * B (C is zero), with no
// instructions spent on zeroing d first (upconv_tc_f32.cu's hi * hi terms).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// v = hi + lo + r with hi = tf32(v), lo = tf32(v - hi), both rounded to
// nearest with ties away from zero (cvt.rna); v - hi is exact in f32, so
// |r| <= 2^-22 |v|. ops/kernels/conv3d.py::tf32_rna rounds the weights on
// the host the same way.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// 16 bytes of `base` from byte offset off (any alignment), as aligned word
// loads through the read-only path; words at or past byte `total` read as
// 0, so a group that runs past the tensor's end stays inside it. base
// must be 16-byte aligned.
__device__ __forceinline__ uint4 ld_bytes16(const int8_t* base, int64_t off,
                                            int64_t total) {
  if ((off & 15) == 0 && off + 16 <= total) {
    return __ldg(reinterpret_cast<const uint4*>(base + off));
  }
  if ((off & 7) == 0 && off + 16 <= total) {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(base + off));
    const uint2 hi = __ldg(reinterpret_cast<const uint2*>(base + off + 8));
    return make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  const uint32_t* p = reinterpret_cast<const uint32_t*>(base);
  const int64_t w0 = off >> 2, nw = (total + 3) >> 2;
  const int sh = static_cast<int>(off & 3) * 8;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = w0 + i < nw ? __ldg(p + w0 + i) : 0u;
  return make_uint4(__funnelshift_r(v[0], v[1], sh),
                    __funnelshift_r(v[1], v[2], sh),
                    __funnelshift_r(v[2], v[3], sh),
                    __funnelshift_r(v[3], v[4], sh));
}

// 8 bytes of `base` from byte offset off (any alignment), as ld_bytes16.
__device__ __forceinline__ uint2 ld_bytes8(const int8_t* base, int64_t off,
                                           int64_t total) {
  if ((off & 7) == 0 && off + 8 <= total) {
    return __ldg(reinterpret_cast<const uint2*>(base + off));
  }
  const uint32_t* p = reinterpret_cast<const uint32_t*>(base);
  const int64_t w0 = off >> 2, nw = (total + 3) >> 2;
  const int sh = static_cast<int>(off & 3) * 8;
  uint32_t v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = w0 + i < nw ? __ldg(p + w0 + i) : 0u;
  return make_uint2(__funnelshift_r(v[0], v[1], sh),
                    __funnelshift_r(v[1], v[2], sh));
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
