// K7a and K7b: ConvTranspose3d(k2, s2) + bias, depth-to-space, on one
// operand or on the channel concat of two.
//
// The direct route: K7a/K7b run on the tensor cores in upconv_tc.cu; this
// CUDA-core kernel is reachable as ops/kernels/convt.py::convt_k2s2_direct
// and ::convt_k2s2_dual_direct, timed beside it, and is the start of their
// f32 mode (ROADMAP Queue 2 A1).
//
// K7a replaces ctunet_tpu/ops/pallas/convt.py::conv_transpose_k2s2 (kernel
// body _kernel), K7b conv_transpose_k2s2_dual (_kernel_dual): the
// transposed conv of the legacy k=5 family's decoder blocks, whose input is
// cat(previous block output, encoder skip) from the second block on. The
// TPU kernels run one matmul per (a, b) output parity over an H tile and
// emit a W-packed-by-2 layout (tiling needs Wh % 8 == 0); both are TPU
// layout devices and are not carried over. The function, on dense
// channels-last volumes (flax transpose_kernel layout, no spatial flip):
//
//   out[2z+a, 2y+b, 2x+c, o] = bf16(bias[o]
//       + sum_i A[z,y,x,i] * Wa[a,b,c,i,o] + sum_j B[z,y,x,j] * Wb[a,b,c,j,o])
//
// (the B sum only in the dual form): bf16 operands and weights, f32
// accumulation, the f32 bias added before the one rounding. The dual form
// never builds the concat.
//
// What bounds it on an H100: each input voxel feeds 8 output voxels with no
// overlap, 16*Ct*Co flops per input voxel against 2*Ct + 16*Co bytes (Ct =
// Ca + Cb): ~25 flop/B at (14+14)->28, far under the bf16 tensor-core ridge,
// so the card's bound is the bytes, above all the 8x larger output. On the
// CUDA cores the f32 FMAs (ridge ~20 flop/B) are close to that line too.
//
// Design: one thread per output voxel and per block of COB=8 output
// channels (grid.y walks the channel blocks); neighbouring threads write
// neighbouring output voxels. A block stages only its channel block's
// 8*Ct*COB f32 weights (all 8 parities; 28 KB at Ct = 112, 32 KB at 128),
// not all 8*Ct*Co (401 KB at 112), and reads them as broadcast float4s.
#include "common.cuh"

using namespace ctunet;

namespace {

__global__ void __launch_bounds__(THREADS)
convt_k2s2_kernel(const __nv_bfloat16* __restrict__ a,
                  const __nv_bfloat16* __restrict__ b,
                  const __nv_bfloat16* __restrict__ wa,
                  const __nv_bfloat16* __restrict__ wb,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int Dh, int Hh, int Wh,
                  int Ca, int Cb, int Co) {
  extern __shared__ __align__(16) float ws[];  // [8][Ca+Cb][COB]
  const int ct = Ca + Cb;
  const int co0 = blockIdx.y * COB;
  const int nw = 8 * ct * COB;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int j = i % COB, r = i / COB, co = co0 + j;
    const int par = r / ct, c = r % ct;
    float val = 0.f;
    if (co < Co) {
      val = c < Ca ? bf(wa[(static_cast<int64_t>(par) * Ca + c) * Co + co])
                   : bf(wb[(static_cast<int64_t>(par) * Cb + (c - Ca)) * Co +
                           co]);
    }
    ws[i] = val;
  }
  __syncthreads();  // the only barrier: threads may leave after it

  const int W = 2 * Wh, H = 2 * Hh;
  const int64_t n = static_cast<int64_t>(2 * Dh) * H * W;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (v >= n) return;
  const int xo = static_cast<int>(v % W);
  const int64_t zy = v / W;
  const int yo = static_cast<int>(zy % H);
  const int zo = static_cast<int>(zy / H);
  const int par = ((zo & 1) * 2 + (yo & 1)) * 2 + (xo & 1);
  const int64_t iv =
      (static_cast<int64_t>(zo >> 1) * Hh + (yo >> 1)) * Wh + (xo >> 1);

  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  const float* wp = ws + par * ct * COB;
  const __nv_bfloat16* ap = a + iv * Ca;
  for (int ci = 0; ci < Ca; ++ci) fma_cob(acc, bf(ap[ci]), wp + ci * COB);
  if (Cb > 0) {
    const __nv_bfloat16* bp = b + iv * Cb;
    wp += Ca * COB;
    for (int cj = 0; cj < Cb; ++cj) fma_cob(acc, bf(bp[cj]), wp + cj * COB);
  }

  __nv_bfloat16* op = out + v * Co;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int co = co0 + j;
    if (co < Co) op[co] = __float2bfloat16(acc[j] + bias[co]);
  }
}

int launch(const void* a, const void* b, const void* wa, const void* wb,
           const void* bias, void* out, int Dh, int Hh, int Wh, int Ca,
           int Cb, int Co, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(8) * (Ca + Cb) * COB * sizeof(float);
  err = allow_smem(convt_k2s2_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(8) * Dh * Hh * Wh;
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS),
                  (Co + COB - 1) / COB);
  convt_k2s2_kernel<<<grid, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(wa),
      static_cast<const __nv_bfloat16*>(wb), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), Dh, Hh, Wh, Ca, Cb, Co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7a: one operand a (Dh, Hh, Wh, Ca), weights (2, 2, 2, Ca, Co).
extern "C" int ctunet_convt_k2s2(const void* a, const void* wa,
                                 const void* bias, void* out, int Dh, int Hh,
                                 int Wh, int Ca, int Co, int device,
                                 void* stream) {
  return launch(a, nullptr, wa, nullptr, bias, out, Dh, Hh, Wh, Ca, 0, Co,
                device, stream);
}

// K7b: cat(a, b) without the concat; wa (2,2,2,Ca,Co), wb (2,2,2,Cb,Co).
extern "C" int ctunet_convt_k2s2_dual(const void* a, const void* b,
                                      const void* wa, const void* wb,
                                      const void* bias, void* out, int Dh,
                                      int Hh, int Wh, int Ca, int Cb, int Co,
                                      int device, void* stream) {
  return launch(a, b, wa, wb, bias, out, Dh, Hh, Wh, Ca, Cb, Co, device,
                stream);
}
