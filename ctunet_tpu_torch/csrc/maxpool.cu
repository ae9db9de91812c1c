// The direct 2x2x2 stride-2 max pool, channels-last, bf16 and f32 (K2) and
// int8 (K2q): the kernel K2 and K2q launched before the row-streaming
// csrc/maxpool_rows.cu. No path launches it; it is reachable only as
// ops/kernels/conv3d.py::maxpool2_direct, maxpool2_f32_direct and
// maxpool2_q_direct, which count no launches, and chip_smoke.py times it
// beside its successor.
//
// Port of ctunet_tpu/ops/pallas/conv3d.py::maxpool2_chain (kernel body
// _pool_kernel), in its bf16 and f32 modes (the JAX engine pools in its
// compute dtype) and its int8 mode (fill=-128, the int8 engine's zero
// point; the dense output has no halo, so the fill has no counterpart here
// and int8 max is exact). The TPU kernel pools the W-packed chain layout,
// taking the W-pair max with two 0/1 selection matmuls on the otherwise
// idle MXU and re-packing to pack/2; none of that applies to a dense volume:
//
//   out[z,y,x,c] = max_{a,b,d in {0,1}} in[2z+a, 2y+b, 2x+d, c]
//
// (odd extents floor, like F.max_pool3d; NaN propagates like PyTorch's).
//
// What bounds it on an H100: one comparison per input value, so it is
// memory bound: it must read the input once (8 values per output) and
// write 1/8 of that back, e.g. 290 MB + 36 MB at the 224x304x304x7 bf16
// layer, about 0.1 ms at 3.35 TB/s (half that in int8, twice in f32:
// 580 MB + 72 MB, 0.19 ms).
//
// Design: one thread per output element (voxel, channel), so a warp reads
// the C contiguous channels of neighbouring voxels and writes contiguous
// outputs; the 8 loads are plain element loads from L1/L2-backed global
// memory. In f32, where C % 4 == 0 and both tensors start on a 16-byte
// boundary, one thread takes four channels with 16-byte loads and stores
// instead (a 7-channel row is not aligned, so it keeps the element path).
// The max is exact, so the result equals the plain version bit for bit.
#include "common.cuh"

using namespace ctunet;

namespace {

// The pooled value type's conversions: bf16 compares in f32 (NaN kept),
// int8 in int.
struct Bf16 {
  using T = __nv_bfloat16;
  using A = float;
  static __device__ A lowest() {
    return __int_as_float(static_cast<int>(0xff800000u));  // -inf
  }
  static __device__ A load(T v) { return bf(v); }
  static __device__ T store(A v) { return __float2bfloat16(v); }
  static __device__ bool take(A v, A m) { return v > m || v != v; }
};

struct F32 {
  using T = float;
  using A = float;
  static __device__ A lowest() {
    return __int_as_float(static_cast<int>(0xff800000u));  // -inf
  }
  static __device__ A load(T v) { return v; }
  static __device__ T store(A v) { return v; }
  static __device__ bool take(A v, A m) { return v > m || v != v; }
};

struct Int8 {
  using T = int8_t;
  using A = int;
  static __device__ A lowest() { return -128; }
  static __device__ A load(T v) { return v; }
  static __device__ T store(A v) { return static_cast<T>(v); }
  static __device__ bool take(A v, A m) { return v > m; }
};

template <typename P>
__global__ void __launch_bounds__(THREADS)
maxpool2_kernel(const typename P::T* __restrict__ x,
                typename P::T* __restrict__ out, int D, int H, int W,
                int C) {
  const int D2 = D / 2, H2 = H / 2, W2 = W / 2;
  const int64_t n = static_cast<int64_t>(D2) * H2 * W2 * C;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % C);
  int64_t t = i / C;
  const int ox = static_cast<int>(t % W2);
  t /= W2;
  const int oy = static_cast<int>(t % H2);
  const int oz = static_cast<int>(t / H2);
  typename P::A m = P::lowest();
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const typename P::A v = P::load(
            x[((static_cast<int64_t>(2 * oz + dz) * H + 2 * oy + dy) * W +
               2 * ox + dx) * C + c]);
        m = P::take(v, m) ? v : m;  // a bf16 NaN, once taken, stays
      }
  out[i] = P::store(m);
}

// f32, four channels a thread: C % 4 == 0, x and out 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
maxpool2_f32x4_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                      int D, int H, int W, int C4) {
  const int D2 = D / 2, H2 = H / 2, W2 = W / 2;
  const int64_t n = static_cast<int64_t>(D2) * H2 * W2 * C4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % C4);
  int64_t t = i / C4;
  const int ox = static_cast<int>(t % W2);
  t /= W2;
  const int oy = static_cast<int>(t % H2);
  const int oz = static_cast<int>(t / H2);
  float m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = F32::lowest();
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float4 v = x[((static_cast<int64_t>(2 * oz + dz) * H + 2 * oy +
                             dy) * W + 2 * ox + dx) * C4 + c];
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          m[k] = F32::take(vs[k], m[k]) ? vs[k] : m[k];
      }
  out[i] = make_float4(m[0], m[1], m[2], m[3]);
}

template <typename P>
int launch(const void* x, void* out, int D, int H, int W, int C, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(D / 2) * (H / 2) * (W / 2) * C;
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS));
  maxpool2_kernel<P><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename P::T*>(x), static_cast<typename P::T*>(out),
      D, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ctunet_maxpool2(const void* x, void* out, int D, int H, int W,
                               int C, int device, void* stream) {
  return launch<Bf16>(x, out, D, H, W, C, device, stream);
}

extern "C" int ctunet_maxpool2_f32(const void* x, void* out, int D, int H,
                                   int W, int C, int device, void* stream) {
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec) return launch<F32>(x, out, D, H, W, C, device, stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(D / 2) * (H / 2) * (W / 2) * (C / 4);
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS));
  maxpool2_f32x4_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), D, H, W, C / 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctunet_maxpool2_q(const void* x, void* out, int D, int H,
                                 int W, int C, int device, void* stream) {
  return launch<Int8>(x, out, D, H, W, C, device, stream);
}
