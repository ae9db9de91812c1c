// K5: Conv3D(k5, SAME, stride 1) + bias + optional ReLU, the direct
// kernel. On the paths it runs every conv of the legacy f32 engine
// (ops/kernels/conv3d.py::conv3d5_f32); bf16 convs run conv3d_tc.cu on the
// tensor cores, and this kernel's bf16 form is kept for timing beside it
// (conv3d5_bias_act_direct).
//
// Replaces ctunet_tpu/ops/pallas/conv3d.py::conv3d_fused (kernel body
// _kernel) at k = 5, the conv of the legacy k=5 family (recAE_v2_fixed,
// UNet4_2IC): ctunet_tpu/engine.py::_FusedUnit.__call__ inside
// _build_legacy_predict. The TPU kernel packs W into the MXU's lanes
// (k*k*3 packed taps over a flattened, padded slab) and its H tiling only
// fits H a multiple of 8; the packing exists to fill a 128-lane matrix unit
// and is not carried over. Here the function is computed on the dense
// channels-last volume, any D, H, W:
//
//   out[z,y,x,o] = T(act(bias[o] + sum_{dz,dy,dx in 0..4, i}
//                  x[z+dz-2, y+dy-2, x+dx-2, i] * w[dz,dy,dx,i,o]))
//
// with zero padding, x, w and out of type T (bf16 or f32), an f32 bias, f32
// accumulation and act = ReLU (the serving engine) or the identity (a flag,
// for the training conv).
//
// What bounds it on an H100: 250*Ci*Co flops per voxel against
// 2*(Ci+Co) bytes, i.e. 125*Ci*Co/(Ci+Co) flop/B (437 at 7->7): above the
// bf16 tensor-core ridge (~295 flop/B) for every layer but the 2->7 input
// conv, so the tensor-core bound is set by the operations. This first
// kernel is a direct convolution on the CUDA cores and is bound by f32 FMA
// issue (67 TFLOP/s peak), far from the tensor-core bound.
//
// Design: K1's (conv3d.cu): one thread per output voxel and per block of
// COB=8 output channels, f32 accumulators in registers, input voxels read
// straight from global memory. K1 stages all 27*Ci*COB f32 weights of the
// channel block; at k=5 that is 125*Ci*32 B (448 KB at Ci = 112), above
// the 227 KB a block can hold. So the weights are staged one dz plane at a
// time (25*Ci*32 B: 100 KB at Ci = 128, recAE_v2_fixed's widest layer),
// with a barrier before and after each stage. Every thread of the block
// reaches every barrier: threads past the last voxel stage weights and
// skip the arithmetic instead of returning early. Borders are masked per
// tap, so ragged extents (the 14x19x19 center) run here too.
#include "common.cuh"

using namespace ctunet;

namespace {

template <int K, typename T, bool RELU>
__global__ void __launch_bounds__(THREADS)
conv3d_plane_staged_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const float* __restrict__ bias,
                           T* __restrict__ out, int D, int H, int W, int Ci,
                           int Co) {
  extern __shared__ __align__(16) float ws[];  // [K][K][Ci][COB], one dz
  constexpr int P = K / 2;
  const int co0 = blockIdx.y * COB;
  const int nw = K * K * Ci * COB;

  const int64_t n = static_cast<int64_t>(D) * H * W;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const bool live = v < n;
  const int64_t vl = live ? v : 0;
  const int xw = static_cast<int>(vl % W);
  const int64_t zy = vl / W;
  const int yh = static_cast<int>(zy % H);
  const int zd = static_cast<int>(zy / H);

  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;

  for (int dz = 0; dz < K; ++dz) {
    __syncthreads();  // every read of the previous plane is done
    const int64_t plane = static_cast<int64_t>(dz) * K * K * Ci;
    for (int i = threadIdx.x; i < nw; i += blockDim.x) {
      const int j = i % COB, tc = i / COB, co = co0 + j;
      ws[i] = co < Co ? ld(w[(plane + tc) * Co + co]) : 0.f;
    }
    __syncthreads();
    const int z = zd + dz - P;
    if (!live || z < 0 || z >= D) continue;
    for (int dy = 0; dy < K; ++dy) {
      const int y = yh + dy - P;
      if (y < 0 || y >= H) continue;
      for (int dx = 0; dx < K; ++dx) {
        const int xx = xw + dx - P;
        if (xx < 0 || xx >= W) continue;
        const T* xp = x + ((static_cast<int64_t>(z) * H + y) * W + xx) * Ci;
        const float* wp = ws + (dy * K + dx) * Ci * COB;
        for (int ci = 0; ci < Ci; ++ci) fma_cob(acc, ld(xp[ci]), wp + ci * COB);
      }
    }
  }
  if (!live) return;

  T* op = out + v * Co;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int co = co0 + j;
    if (co < Co) {
      const float r = acc[j] + bias[co];
      st(op + co, RELU ? fmaxf(r, 0.f) : r);
    }
  }
}

template <int K, typename T, bool RELU>
int launch(const void* x, const void* w, const void* bias, void* out, int D,
           int H, int W, int Ci, int Co, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(K) * K * Ci * COB * sizeof(float);
  err = allow_smem(conv3d_plane_staged_kernel<K, T, RELU>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(D) * H * W;
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS),
                  (Co + COB - 1) / COB);
  conv3d_plane_staged_kernel<K, T, RELU>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const float*>(bias), static_cast<T*>(out), D, H, W, Ci,
          Co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5 on bf16 tensors: the direct form that conv3d_tc.cu replaced, kept for
// timing beside it.
extern "C" int ctunet_conv3d5_bias_act(const void* x, const void* w,
                                       const void* bias, void* out, int D,
                                       int H, int W, int Ci, int Co, int relu,
                                       int device, void* stream) {
  return relu ? launch<5, __nv_bfloat16, true>(x, w, bias, out, D, H, W, Ci,
                                               Co, device, stream)
              : launch<5, __nv_bfloat16, false>(x, w, bias, out, D, H, W,
                                                Ci, Co, device, stream);
}

// K5 in f32: every conv of the legacy f32 engine.
extern "C" int ctunet_conv3d5_bias_act_f32(const void* x, const void* w,
                                           const void* bias, void* out, int D,
                                           int H, int W, int Ci, int Co,
                                           int relu, int device,
                                           void* stream) {
  return relu ? launch<5, float, true>(x, w, bias, out, D, H, W, Ci, Co,
                                       device, stream)
              : launch<5, float, false>(x, w, bias, out, D, H, W, Ci, Co,
                                        device, stream);
}
