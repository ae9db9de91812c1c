// K3: ConvTranspose(k2, s2) + bias over cat(a, b), composed with the next
// Conv3D(k3) + folded BatchNorm + ReLU, evaluated from the half-resolution
// inputs. bf16 or f32 in and out (T), f32 accumulation.
//
// The direct route. In f32 it is K3's kernel on the paths (the f32 serving
// engine and the int8 engine's float tail: ops/kernels/upconv.py::
// upconv_f32); a bf16 K3 runs on the tensor cores in upconv_tc.cu, and this
// kernel's bf16 form is reachable as upconv_bn_relu_direct, timed beside
// it. The f32 form rounds nowhere but in its f32 sums: the composite R is
// built in f64 and rounded once to f32 on the host.
//
// Replaces ctunet_tpu/ops/pallas/upconv.py::upconv_fused_chain_split
// (kernel body _upconv_kernel_split). Both linear maps compose into one
// 4x4x4 response R (built on the host in f64, see
// ops/kernels/upconv.py::composite_response), and
//
//   out[v,o] = T(relu(bias[o] + sum_u sum_i R[v-2u+1, i, o] in[u, i]))
//
// over the half-resolution neighbours u with 0 <= v-2u+1 <= 3: per
// dimension and output parity p exactly two taps, u = m+p-1+t with
// R index 3-p-2t (v = 2m+p, t in {0,1}), so 8 taps per output voxel. The
// input channels are a's, then one ones-channel that carries the convT
// bias, then b's (the encoder skip; the concat is never built). The ones
// channel is 1 inside the half-resolution volume and 0 outside, so its
// response `wone` is added only for taps whose u lies inside: near every
// face the bias term depends on position, and a kernel that added it as a
// constant would be wrong within one voxel of the border.
//
// The TPU kernel lays the same sum out as per-parity packed matrices over
// its lane-packed chain layout (8 main + 2 boundary dots per parity pair);
// that layout is for the MXU and is not carried over.
//
// What bounds it on an H100: 16*(Ca+Cb)*Co flops per output voxel against
// (Ca+Cb)/8*sizeof(T) + sizeof(T)*Co bytes; at the full-resolution level
// (14+14 -> 7) 65 GFLOP over 0.43 GB in bf16 (0.86 GB in f32), i.e. ~75-150
// flop/B. In f32 the card's bound is the operations: 65 GFLOP at the 67
// TFLOP/s of its f32 CUDA cores is 0.97 ms, the bytes 0.26 ms.
//
// Design: grid.z is the output parity class (8), grid.y the block of COB=8
// output channels, grid.x the half-resolution voxel; each thread computes
// one output voxel of its parity, so a block needs only its parity's 8
// taps of R, staged once in shared memory as f32 (8*(Ca+Cb+1)*COB
// floats, 29 KB at 56+56 channels, either T). The ones channel's taps are
// skipped with the operands' where u lies outside, so the bias term is
// exact at every face. Making the f32 form fast is later work.
#include "common.cuh"

using namespace ctunet;

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
upconv_bn_relu_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ wa, const T* __restrict__ wb,
                      const T* __restrict__ wone,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int D2, int H2, int W2, int Ca, int Cb, int Co) {
  extern __shared__ __align__(16) float ws[];  // [8 taps][Ca+Cb+1][COB]
  const int par = blockIdx.z;
  const int pz = par >> 2, py = (par >> 1) & 1, px = par & 1;
  const int co0 = blockIdx.y * COB;
  const int ct = Ca + Cb + 1;
  const int nw = 8 * ct * COB;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int j = i % COB, r = i / COB, c = r % ct, tap = r / ct;
    const int kz = 3 - pz - 2 * (tap >> 2);
    const int ky = 3 - py - 2 * ((tap >> 1) & 1);
    const int kx = 3 - px - 2 * (tap & 1);
    const int k = (kz * 4 + ky) * 4 + kx, co = co0 + j;
    float val = 0.f;
    if (co < Co) {
      if (c < Ca)
        val = ld(wa[(static_cast<int64_t>(k) * Ca + c) * Co + co]);
      else if (c < Ca + Cb)
        val = ld(wb[(static_cast<int64_t>(k) * Cb + (c - Ca)) * Co + co]);
      else
        val = ld(wone[k * Co + co]);
    }
    ws[i] = val;
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

  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;

  for (int tap = 0; tap < 8; ++tap) {
    const int uz = mz + pz - 1 + (tap >> 2);
    const int uy = my + py - 1 + ((tap >> 1) & 1);
    const int ux = mx + px - 1 + (tap & 1);
    if (uz < 0 || uz >= D2 || uy < 0 || uy >= H2 || ux < 0 || ux >= W2)
      continue;
    const int64_t u = (static_cast<int64_t>(uz) * H2 + uy) * W2 + ux;
    const float* wp = ws + tap * ct * COB;
    const T* ap = a + u * Ca;
    for (int c = 0; c < Ca; ++c) fma_cob(acc, ld(ap[c]), wp + c * COB);
    const T* bp = b + u * Cb;
    for (int c = 0; c < Cb; ++c) fma_cob(acc, ld(bp[c]), wp + (Ca + c) * COB);
    fma_cob(acc, 1.f, wp + (Ca + Cb) * COB);  // the ones channel
  }

  const int64_t o = ((static_cast<int64_t>(2 * mz + pz) * (2 * H2) +
                      2 * my + py) * (2 * W2) + 2 * mx + px) * Co;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int co = co0 + j;
    if (co < Co) st(out + o + co, fmaxf(acc[j] + bias[co], 0.f));
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* wa, const void* wb,
           const void* wone, const void* bias, void* out, int D2, int H2,
           int W2, int Ca, int Cb, int Co, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(8) * (Ca + Cb + 1) * COB * sizeof(float);
  err = allow_smem(upconv_bn_relu_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n2 = static_cast<int64_t>(D2) * H2 * W2;
  const dim3 grid(static_cast<unsigned>((n2 + THREADS - 1) / THREADS),
                  (Co + COB - 1) / COB, 8);
  upconv_bn_relu_kernel<T><<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(wa), static_cast<const T*>(wb),
      static_cast<const T*>(wone), static_cast<const float*>(bias),
      static_cast<T*>(out), D2, H2, W2, Ca, Cb, Co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3 on bf16 tensors (timing beside upconv_tc.cu); b and wb null when Cb = 0.
extern "C" int ctunet_upconv_bn_relu(const void* a, const void* b,
                                     const void* wa, const void* wb,
                                     const void* wone, const void* bias,
                                     void* out, int D2, int H2, int W2,
                                     int Ca, int Cb, int Co, int device,
                                     void* stream) {
  return launch<__nv_bfloat16>(a, b, wa, wb, wone, bias, out, D2, H2, W2, Ca,
                               Cb, Co, device, stream);
}

// K3 in f32.
extern "C" int ctunet_upconv_bn_relu_f32(const void* a, const void* b,
                                         const void* wa, const void* wb,
                                         const void* wone, const void* bias,
                                         void* out, int D2, int H2, int W2,
                                         int Ca, int Cb, int Co, int device,
                                         void* stream) {
  return launch<float>(a, b, wa, wb, wone, bias, out, D2, H2, W2, Ca, Cb, Co,
                       device, stream);
}
