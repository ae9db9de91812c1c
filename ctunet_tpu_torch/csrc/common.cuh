// Shared helpers of the port's Hopper kernels (plain C interface, no
// PyTorch headers: each .cu builds with nvcc alone in seconds).
//
// Layout: every activation is a dense channels-last bf16 volume
// (D, H, W, C), C fastest; weights are tap-major (taps..., Cin, Cout) bf16;
// biases are f32. Kernels accumulate in f32 and store bf16 (round to
// nearest even, as PyTorch's cast does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ctunet {

// Output channels one thread accumulates (one block of the grid's y axis).
constexpr int COB = 8;
// Threads per block of the direct-convolution kernels.
constexpr int THREADS = 256;

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc[0..COB) += xv * w[0..COB): w is 16-byte aligned shared memory.
__device__ __forceinline__ void fma_cob(float (&acc)[COB], float xv,
                                        const float* w) {
  const float4 w0 = *reinterpret_cast<const float4*>(w);
  const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
  acc[0] = fmaf(xv, w0.x, acc[0]);
  acc[1] = fmaf(xv, w0.y, acc[1]);
  acc[2] = fmaf(xv, w0.z, acc[2]);
  acc[3] = fmaf(xv, w0.w, acc[3]);
  acc[4] = fmaf(xv, w1.x, acc[4]);
  acc[5] = fmaf(xv, w1.y, acc[5]);
  acc[6] = fmaf(xv, w1.z, acc[6]);
  acc[7] = fmaf(xv, w1.w, acc[7]);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ctunet
