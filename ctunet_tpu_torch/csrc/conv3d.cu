// K1 and K6: Conv3D(k3, SAME, stride 1) + bias + optional ReLU, the
// direct kernel. On the paths it runs every f32 k=3 conv: K1 of the f32
// serving engines (and of the int8 engine's float units) and K6 in f32
// training (ops/kernels/conv3d.py::conv3d_f32). bf16 convs run
// conv3d_tc.cu on the tensor cores, and this kernel's bf16 form is kept for
// timing beside it (conv3d_bias_act_direct).
//
// K1 replaces ctunet_tpu/ops/pallas/conv3d.py::conv3d_chain_split (kernel
// body _chain_kernel_ring_split), bf16 and f32 modes, with the BatchNorm
// folded into the weights and the bias and the ReLU on. K6 replaces
// ctunet_tpu/ops/pallas/conv3d.py::conv3d_chain (the 27-tap ring kernel):
// the same function with the ReLU chosen by a flag and bf16 or f32 tensors;
// training calls it with a zero bias and no ReLU, forward and (on flipped,
// channel-swapped weights) as the input gradient. The TPU kernels pack W
// into the 128 MXU lanes, keep halo rows and a ones-channel inside a flat
// "chain" layout and split or ring-buffer the 27 taps; all of that exists
// to fill the TPU's matrix unit and is not carried over. Here the function
// is computed on the dense channels-last volume:
//
//   out[z,y,x,o] = T(act(bias[o] + sum_{dz,dy,dx,i} x[z+dz-1, y+dy-1,
//                  x+dx-1, i] * w[dz,dy,dx,i,o]))     (zero padding)
//
// with x, w and out of type T (bf16 or f32), bias f32, f32 accumulation and
// act = ReLU or identity. Both entry points instantiate one template, so
// K1 is K6 with T = bf16 and the ReLU on.
//
// What bounds it on an H100: the layers are thin (Cin, Cout in 2..112), so
// the work is 54*Cin*Cout flops per voxel against 2*(Cin+Cout) bytes: at
// the full-resolution 7->7 layer 55 GFLOP over 0.58 GB, i.e. ~95 flop/B,
// under the bf16 tensor-core ridge (~295 flop/B) but far above the f32
// CUDA-core ridge (~20 flop/B). This first kernel is a direct convolution
// on the CUDA cores, so it is bound by f32 FMA issue, not by memory.
//
// Design: one thread per output voxel and per block of COB=8 output
// channels (grid.y walks the channel blocks), f32 accumulators in
// registers. The block's 27*Cin*COB weights are staged once in shared
// memory as f32 (96.8 KB at Cin = 112: above 48 KB the launch opts in) and
// read as broadcast float4s; input voxels are read straight from global
// memory (neighbouring threads read neighbouring voxels, and the 27-fold
// reuse is served by L1/L2). Borders are masked per tap, so any D, H, W
// (ragged 19x19, W=304) is fine. The tensor-core form is conv3d_tc.cu.
#include "common.cuh"

using namespace ctunet;

template <typename T, bool RELU>
__global__ void __launch_bounds__(THREADS)
conv3d_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int D, int H, int W, int Ci, int Co) {
  extern __shared__ __align__(16) float ws[];  // [27][Ci][COB]
  const int co0 = blockIdx.y * COB;
  const int nw = 27 * Ci * COB;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int j = i % COB, tc = i / COB, co = co0 + j;
    ws[i] = co < Co ? ld(w[static_cast<int64_t>(tc) * Co + co]) : 0.f;
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

  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;

  for (int dz = 0; dz < 3; ++dz) {
    const int z = zd + dz - 1;
    if (z < 0 || z >= D) continue;
    for (int dy = 0; dy < 3; ++dy) {
      const int y = yh + dy - 1;
      if (y < 0 || y >= H) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = xw + dx - 1;
        if (xx < 0 || xx >= W) continue;
        const T* xp = x + ((static_cast<int64_t>(z) * H + y) * W + xx) * Ci;
        const float* wp = ws + ((dz * 3 + dy) * 3 + dx) * Ci * COB;
        for (int ci = 0; ci < Ci; ++ci) fma_cob(acc, ld(xp[ci]), wp + ci * COB);
      }
    }
  }

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

template <typename T, bool RELU>
static int launch(const void* x, const void* w, const void* bias, void* out,
                  int D, int H, int W, int Ci, int Co, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(27) * Ci * COB * sizeof(float);
  err = allow_smem(conv3d_bias_act_kernel<T, RELU>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(D) * H * W;
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS),
                  (Co + COB - 1) / COB);
  conv3d_bias_act_kernel<T, RELU>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const float*>(bias), static_cast<T*>(out), D, H, W, Ci,
          Co);
  return static_cast<int>(cudaGetLastError());
}

// K6 (and K1 with relu = 1) on bf16 tensors: the direct form that
// conv3d_tc.cu replaced, kept for timing beside it.
extern "C" int ctunet_conv3d_bias_act(const void* x, const void* w,
                                      const void* bias, void* out, int D,
                                      int H, int W, int Ci, int Co, int relu,
                                      int device, void* stream) {
  return relu ? launch<__nv_bfloat16, true>(x, w, bias, out, D, H, W, Ci, Co,
                                            device, stream)
              : launch<__nv_bfloat16, false>(x, w, bias, out, D, H, W, Ci, Co,
                                             device, stream);
}

// K1 (relu = 1) and K6 in f32: every f32 k=3 conv of the paths.
extern "C" int ctunet_conv3d_bias_act_f32(const void* x, const void* w,
                                          const void* bias, void* out, int D,
                                          int H, int W, int Ci, int Co,
                                          int relu, int device,
                                          void* stream) {
  return relu ? launch<float, true>(x, w, bias, out, D, H, W, Ci, Co, device,
                                    stream)
              : launch<float, false>(x, w, bias, out, D, H, W, Ci, Co, device,
                                     stream);
}
