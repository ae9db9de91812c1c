// K1q: int8 Conv3D(k3, SAME, stride 1) + requant epilogue, int32 accumulation.
//
// Replaces the int8 modes of ctunet_tpu/ops/pallas/conv3d.py:
// conv3d_chain_split(scale=, zp=) (kernel body _chain_kernel_ring_split,
// epilogue :1001-1013) and conv3d_chain_q (K4a, body _chain_kernel_ring_q,
// epilogue :1597-1612). Both TPU forms compute the same integers (split vs
// full taps is a packing choice for the MXU); on the dense channels-last
// volume the function is
//
//   acc[v,o] = sum_{tap,i} q_w[tap,i,o] * x[v+tap-1, i]     (exact int32)
//   r        = relu(fma(f32(acc), scale[o], bias[o]))       (one rounding)
//   zp mode:  out = rint(min(r, 255) - 128)                 (f32 subtract)
//   symmetric: out = rint(min(r, 127))
//
// An out-of-volume tap reads the layout's fill: -128 in zp mode (the
// activation zero, whose 128*sum(q_w) correction the caller folded into
// `bias` over all 27 taps) or 0 in symmetric mode. Skipping such a tap, as
// the bf16 K1 does, would be wrong at every border voxel in zp mode, so the
// block precomputes sum_i q_w[tap,i,o] per tap and adds fill * that sum.
//
// Bit-exactness: f32(acc) rounds to nearest (__int2float_rn: |acc| reaches
// ~5e7 > 2^24), acc * scale + bias rounds once (__fmaf_rn), as XLA
// contracts the Pallas epilogue's multiply-add into a fused multiply-add,
// and the result rounds half to even (__float2int_rn), as jnp.round does.
//
// What bounds it on an H100: the int8 tensor cores (1,979 TOPS dense) would
// make it memory bound; this first kernel is a direct convolution on the
// CUDA cores (IMAD, 54*Ci*Co int ops per voxel), bound by integer issue.
//
// Design (as K1): one thread per output voxel and per block of COB=8 output
// channels, int32 accumulators in registers, the block's 27*Ci*COB weights
// staged once in shared memory as int32 and read as broadcast int4s.
// dp4a / mma / wgmma tiling is later work.
#include "common.cuh"

using namespace ctunet;

namespace {

__global__ void __launch_bounds__(THREADS)
conv3d_q_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ bias, int8_t* __restrict__ out,
                int D, int H, int W, int Ci, int Co, int zp) {
  extern __shared__ __align__(16) int wsq[];  // [27][Ci][COB] + [27][COB]
  int* wsum = wsq + 27 * Ci * COB;
  const int co0 = blockIdx.y * COB;
  const int nw = 27 * Ci * COB;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int j = i % COB, tc = i / COB, co = co0 + j;
    wsq[i] = co < Co ? static_cast<int>(w[static_cast<int64_t>(tc) * Co + co])
                     : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 27 * COB; i += blockDim.x) {
    const int j = i % COB, tap = i / COB;
    int s = 0;
    for (int ci = 0; ci < Ci; ++ci) s += wsq[(tap * Ci + ci) * COB + j];
    wsum[i] = s;
  }
  __syncthreads();

  const int64_t n = static_cast<int64_t>(D) * H * W;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (v >= n) return;
  const int xw = static_cast<int>(v % W);
  const int64_t zy = v / W;
  const int yh = static_cast<int>(zy % H);
  const int zd = static_cast<int>(zy / H);
  const int fill = zp ? -128 : 0;

  int acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0;

  for (int dz = 0; dz < 3; ++dz) {
    const int z = zd + dz - 1;
    const bool zin = z >= 0 && z < D;
    for (int dy = 0; dy < 3; ++dy) {
      const int y = yh + dy - 1;
      const bool yin = y >= 0 && y < H;
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = xw + dx - 1;
        const int tap = (dz * 3 + dy) * 3 + dx;
        if (!(zin && yin && xx >= 0 && xx < W)) {
          imad_cob(acc, fill, wsum + tap * COB);  // the layout's fill value
          continue;
        }
        const int8_t* xp =
            x + ((static_cast<int64_t>(z) * H + y) * W + xx) * Ci;
        const int* wp = wsq + tap * Ci * COB;
        for (int ci = 0; ci < Ci; ++ci)
          imad_cob(acc, static_cast<int>(xp[ci]), wp + ci * COB);
      }
    }
  }

  int8_t* op = out + v * Co;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int co = co0 + j;
    if (co >= Co) continue;
    op[co] = requant_s8<false>(acc[j], scale[co], bias[co], zp);
  }
}

}  // namespace

extern "C" int ctunet_conv3d_q_requant(const void* x, const void* w,
                                       const void* scale, const void* bias,
                                       void* out, int D, int H, int W, int Ci,
                                       int Co, int zp, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(27) * (Ci + 1) * COB * sizeof(int);
  err = allow_smem(conv3d_q_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(D) * H * W;
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS),
                  (Co + COB - 1) / COB);
  conv3d_q_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<int8_t*>(out), D, H, W, Ci, Co, zp);
  return static_cast<int>(cudaGetLastError());
}
