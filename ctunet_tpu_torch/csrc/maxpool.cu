// K2: 2x2x2 stride-2 max pool, bf16, channels-last.
//
// Replaces ctunet_tpu/ops/pallas/conv3d.py::maxpool2_chain (kernel body
// _pool_kernel). The TPU kernel pools the W-packed chain layout, taking the
// W-pair max with two 0/1 selection matmuls on the otherwise idle MXU and
// re-packing to pack/2; none of that applies to a dense volume:
//
//   out[z,y,x,c] = max_{a,b,d in {0,1}} in[2z+a, 2y+b, 2x+d, c]
//
// (odd extents floor, like F.max_pool3d; NaN propagates like PyTorch's).
//
// What bounds it on an H100: one comparison per input byte pair, so it is
// memory bound: it must read the input once (8 values per output) and
// write 1/8 of that back, e.g. 290 MB + 36 MB at the 224x304x304x7 layer,
// about 0.1 ms at 3.35 TB/s.
//
// Design: one thread per output element (voxel, channel), so a warp reads
// the C contiguous channels of neighbouring voxels and writes contiguous
// outputs; the 8 loads are plain bf16 loads from L1/L2-backed global
// memory. The max is exact, so the result equals the plain version bit for
// bit. Vectorised 16-byte loads are later work.
#include "common.cuh"

using namespace ctunet;

__global__ void __launch_bounds__(THREADS)
maxpool2_kernel(const __nv_bfloat16* __restrict__ x,
                __nv_bfloat16* __restrict__ out, int D, int H, int W,
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
  float m = __int_as_float(static_cast<int>(0xff800000u));  // -inf
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float v = bf(x[((static_cast<int64_t>(2 * oz + dz) * H +
                               2 * oy + dy) * W + 2 * ox + dx) * C + c]);
        m = (v > m || v != v) ? v : m;  // a NaN, once taken, stays
      }
  out[i] = __float2bfloat16(m);
}

extern "C" int ctunet_maxpool2(const void* x, void* out, int D, int H, int W,
                               int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(D / 2) * (H / 2) * (W / 2) * C;
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS));
  maxpool2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), D, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
