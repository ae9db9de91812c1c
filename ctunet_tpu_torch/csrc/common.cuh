// Shared helpers of the port's Hopper kernels (plain C interface, no
// PyTorch headers: each .cu builds with nvcc alone in seconds).
//
// Layout: every activation is a dense channels-last volume (D, H, W, C),
// C fastest; weights are tap-major (taps..., Cin, Cout). The bf16 kernels
// take bf16 weights and f32 biases, accumulate in f32 and store bf16 (round
// to nearest even, as PyTorch's cast does); their f32 forms take f32
// tensors and weights and round nowhere but in the f32 sums; the int8
// kernels take int8
// activations and weights, accumulate in int32 and requantize with f32
// scale and bias.
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

// Loads and stores of the kernels templated on the element type T (bf16 or
// f32): values widen to f32 for the arithmetic; a bf16 store rounds to
// nearest even once, an f32 store keeps every bit.
__device__ __forceinline__ float ld(const __nv_bfloat16 v) { return bf(v); }
__device__ __forceinline__ float ld(const float v) { return v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

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

// acc[0..COB) += xv * w[0..COB) in int32 (the int8 kernels): w is 16-byte
// aligned shared memory holding the int8 weights widened to int.
__device__ __forceinline__ void imad_cob(int (&acc)[COB], int xv,
                                         const int* w) {
  const int4 w0 = *reinterpret_cast<const int4*>(w);
  const int4 w1 = *reinterpret_cast<const int4*>(w + 4);
  acc[0] += xv * w0.x;
  acc[1] += xv * w0.y;
  acc[2] += xv * w0.z;
  acc[3] += xv * w0.w;
  acc[4] += xv * w1.x;
  acc[5] += xv * w1.y;
  acc[6] += xv * w1.z;
  acc[7] += xv * w1.w;
}

// The shared memory one block of an H100 can opt in to.
constexpr size_t kMaxSmemPerBlock = 232448;

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A thread's walk over a shared-memory slab's cells (row r, column c of
// `cols`, 16-byte group g of `groups`), as the tensor-core kernels' slab
// loaders fill it: cell threadIdx.x first, then every THREADS-th, stepped
// without divisions.
struct CellWalk {
  int r, c, g;     // the thread's first cell
  int dr, dc, dg;  // THREADS cells further on
  int cols, groups;

  // (r, c, g) to the thread's next cell
  __device__ __forceinline__ void next(int& r_, int& c_, int& g_) const {
    g_ += dg;
    int carry = g_ >= groups;
    g_ -= carry ? groups : 0;
    c_ += dc + carry;
    carry = c_ >= cols;
    c_ -= carry ? cols : 0;
    r_ += dr + carry;
  }
};

template <int THREADS>
__device__ __forceinline__ CellWalk cell_walk(int cols, int groups) {
  const int v = threadIdx.x / groups, dv = THREADS / groups;
  return {v / cols,  v % cols,  static_cast<int>(threadIdx.x) % groups,
          dv / cols, dv % cols, THREADS % groups,
          cols,      groups};
}

// The int8 requant of an exact int32 sum: r = relu(fma(f32(acc), s, b))
// (__int2float_rn, one __fmaf_rn), clamped to 255 and less 128 in
// zero-point mode, to 127 otherwise, rounded half to even. K1q subtracts
// 128 in f32 before it rounds (conv3d_chain_q's epilogue); K3q rounds,
// then subtracts as an integer (upconv_fused_chain's, ROUND_FIRST). The
// two orders part where r - 128 rounds in f32 (r < 64), so each keeps its
// own.
template <bool ROUND_FIRST>
__device__ __forceinline__ int8_t requant_s8(int acc, float s, float b,
                                             int zp) {
  const float r = fmaxf(__fmaf_rn(__int2float_rn(acc), s, b), 0.f);
  if constexpr (ROUND_FIRST) {
    const int q = __float2int_rn(fminf(r, zp ? 255.f : 127.f));
    return static_cast<int8_t>(zp ? q - 128 : q);
  } else {
    return static_cast<int8_t>(__float2int_rn(
        zp ? __fsub_rn(fminf(r, 255.f), 128.f) : fminf(r, 127.f)));
  }
}

}  // namespace ctunet
