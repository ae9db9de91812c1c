// K3q: int8 fused upsample + conv (ConvT(k2,s2) o Conv3D(k3), quantized as
// one composite response), int32 accumulation, requant epilogue.
//
// Replaces the int8 modes of ctunet_tpu/ops/pallas/upconv.py:
// upconv_fused_chain_split(scale2=, zp=True) (body _upconv_kernel_split,
// epilogue :431-441) and upconv_fused_chain (K4b, body _upconv_kernel,
// epilogue :983-993). The split and full-tap forms are MXU packings of the
// same integers. With the composite r_q[4,4,4,Cin_aug,Co] quantized by the
// caller (engine_q._quant_upconv) and the output voxel v = 2m + p:
//
//   acc[v,o] = sum over the 8 taps u = m+p-1+t (R index 3-p-2t per dim) of
//              in-volume u: sum_i a[u,i] wa[.,i,o] + sum_i b[u,i] wb[.,i,o]
//                           + 127 * wone[.,o]          (the ones lane)
//              outside:     fill * (sum_i wa + sum_i wb + wone)[.,o]
//   r   = relu(fma(f32(acc), scale[o], bias[par(v), o])) (one rounding)
//   zp:  out = rint(min(r, 255)) - 128;  symmetric: out = rint(min(r, 127))
//
// The chain layout's halo holds the fill (-128 in zp mode, 0 otherwise) in
// EVERY lane, the ones lane included, while inside the volume the ones lane
// holds 127 (q of 1.0 at scale 1/255 or 1/127), weighted by the quantized
// ones row of r_q; the bf16 K3 instead skips outside taps and weights the
// ones channel by the f32 row. The bias row depends on the output parity
// (z, y, x): the zero-point correction 128*colsum(r_q)/k runs over the taps
// that reach that parity (engine_q.py:219-247; the JAX kernels keep x
// parity in the lanes and (z, y) in 4 rows, the dense form needs 8 rows).
//
// Bit-exactness: as K1q, __int2float_rn then one __fmaf_rn (XLA fuses the
// Pallas epilogue's multiply-add), and round half to even (__float2int_rn)
// before the -128.
//
// What bounds it on an H100: the int8 tensor cores would make it memory
// bound; this first kernel is direct on the CUDA cores (IMAD, 16*Cin*Co
// int ops per output voxel), bound by integer issue.
//
// Design (as K3): grid.z = output parity, grid.y = block of COB=8 output
// channels, grid.x = half-resolution voxel; the block stages its parity's
// 8 taps of r_q as int32 in shared memory plus the per-tap column sums.
#include "common.cuh"

using namespace ctunet;

namespace {

__global__ void __launch_bounds__(THREADS)
upconv_q_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                const int8_t* __restrict__ wa, const int8_t* __restrict__ wb,
                const int8_t* __restrict__ wone,
                const float* __restrict__ scale,
                const float* __restrict__ bias, int8_t* __restrict__ out,
                int D2, int H2, int W2, int Ca, int Cb, int Co, int zp) {
  // [8 taps][Ca+Cb+1][COB] weights, then [8 taps][COB] column sums
  extern __shared__ __align__(16) int wsq[];
  const int par = blockIdx.z;
  const int pz = par >> 2, py = (par >> 1) & 1, px = par & 1;
  const int co0 = blockIdx.y * COB;
  const int ct = Ca + Cb + 1;
  const int nw = 8 * ct * COB;
  int* wsum = wsq + nw;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int j = i % COB, r = i / COB, c = r % ct, tap = r / ct;
    const int kz = 3 - pz - 2 * (tap >> 2);
    const int ky = 3 - py - 2 * ((tap >> 1) & 1);
    const int kx = 3 - px - 2 * (tap & 1);
    const int k = (kz * 4 + ky) * 4 + kx, co = co0 + j;
    int val = 0;
    if (co < Co) {
      if (c < Ca)
        val = wa[(static_cast<int64_t>(k) * Ca + c) * Co + co];
      else if (c < Ca + Cb)
        val = wb[(static_cast<int64_t>(k) * Cb + (c - Ca)) * Co + co];
      else
        val = wone[k * Co + co];
    }
    wsq[i] = val;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * COB; i += blockDim.x) {
    const int j = i % COB, tap = i / COB;
    int s = 0;
    for (int c = 0; c < ct; ++c) s += wsq[(tap * ct + c) * COB + j];
    wsum[i] = s;
  }
  __syncthreads();

  const int64_t n2 = static_cast<int64_t>(D2) * H2 * W2;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (v >= n2) return;
  const int mx = static_cast<int>(v % W2);
  const int64_t zy = v / W2;
  const int my = static_cast<int>(zy % H2);
  const int mz = static_cast<int>(zy / H2);
  const int fill = zp ? -128 : 0;

  int acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0;

  for (int tap = 0; tap < 8; ++tap) {
    const int uz = mz + pz - 1 + (tap >> 2);
    const int uy = my + py - 1 + ((tap >> 1) & 1);
    const int ux = mx + px - 1 + (tap & 1);
    if (uz < 0 || uz >= D2 || uy < 0 || uy >= H2 || ux < 0 || ux >= W2) {
      imad_cob(acc, fill, wsum + tap * COB);  // every lane holds the fill
      continue;
    }
    const int64_t u = (static_cast<int64_t>(uz) * H2 + uy) * W2 + ux;
    const int* wp = wsq + tap * ct * COB;
    const int8_t* ap = a + u * Ca;
    for (int c = 0; c < Ca; ++c)
      imad_cob(acc, static_cast<int>(ap[c]), wp + c * COB);
    const int8_t* bp = b + u * Cb;
    for (int c = 0; c < Cb; ++c)
      imad_cob(acc, static_cast<int>(bp[c]), wp + (Ca + c) * COB);
    imad_cob(acc, 127, wp + (Ca + Cb) * COB);  // the ones lane inside
  }

  const int64_t o = ((static_cast<int64_t>(2 * mz + pz) * (2 * H2) +
                      2 * my + py) * (2 * W2) + 2 * mx + px) * Co;
  const float* brow = bias + par * Co;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int co = co0 + j;
    if (co >= Co) continue;
    out[o + co] = requant_s8<true>(acc[j], scale[co], brow[co], zp);
  }
}

}  // namespace

extern "C" int ctunet_upconv_q_requant(const void* a, const void* b,
                                       const void* wa, const void* wb,
                                       const void* wone, const void* scale,
                                       const void* bias, void* out, int D2,
                                       int H2, int W2, int Ca, int Cb, int Co,
                                       int zp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(8) * (Ca + Cb + 2) * COB * sizeof(int);
  err = allow_smem(upconv_q_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n2 = static_cast<int64_t>(D2) * H2 * W2;
  const dim3 grid(static_cast<unsigned>((n2 + THREADS - 1) / THREADS),
                  (Co + COB - 1) / COB, 8);
  upconv_q_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int8_t*>(wa), static_cast<const int8_t*>(wb),
      static_cast<const int8_t*>(wone), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<int8_t*>(out), D2, H2, W2,
      Ca, Cb, Co, zp);
  return static_cast<int>(cudaGetLastError());
}
