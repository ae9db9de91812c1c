// The Adam / AdamW update of every f32 leaf of a parameter group as one
// multi-tensor kernel: the arithmetic of ctunet_tpu_torch/steps.py
// Optimizer._update (optax's amsgrad, transform by transform), in place on
// the parameter and its three moments, for many leaves in one launch.
//
// Replaces no TPU kernel: the JAX package leaves the optimizer to XLA, which
// fuses the whole optax chain into a few loops over all leaves. PyTorch runs
// the per-leaf path as about 15 elementwise launches a leaf, so a model of
// 58 leaves queues some 870 launches of a few microseconds each behind the
// backward: the launch queue fills and the host waits in the optimizer until
// the backward has drained. This kernel makes that one launch per table of
// leaves.
//
// Per element, in f32, each operation rounded once as ATen's separate
// kernels round it on the card (the __f*_rn intrinsics keep nvcc from
// contracting a product and a sum into one FMA):
//   g      = g + wd * p                  (adam with weight decay: L2)
//   mu     = (1 - b1) * g + b1 * mu
//   nu     = (1 - b2) * (g * g) + b2 * nu
//   mu_hat = mu * inv_bc1,  nu_hat = nu * inv_bc2
//   nu_max = maximum(nu_max, nu_hat)     (a NaN on either side wins)
//   u      = mu_hat / (sqrt(nu_max) + eps)
//   u      = u + wd * p                  (adamw)
//   u      = -lr * u,  then scale * u    (the plateau scale, when not 1)
//   p      = p + u
// ATen divides a tensor by a host scalar as a product with the scalar's f32
// reciprocal, computed on the host (BinaryDivTrueKernel.cu); inv_bc1 and
// inv_bc2 are those reciprocals, so the results equal the per-leaf path's
// on the card bit for bit.
//
// What bounds it on an H100: bytes. Each element reads five f32 values
// (p, g, mu, nu, nu_max) and writes four: 36 bytes, 22.8 MB for UNetSP's
// 634,595 parameters, 6.8 us at 3.35 TB/s.
//
// Design, as ATen's multi_tensor_apply: the leaves' pointers and sizes go by
// value in the kernel's parameter space (a table of MT_LEAVES leaves and a
// block map of MT_BLOCKS blocks, under the 4 KB of a launch's parameters),
// so nothing is copied to the device and nothing waits. Block b updates
// chunk block_chunk[b] (MT_CHUNK elements) of leaf block_leaf[b]; a leaf
// larger than a chunk takes several blocks, and one that does not fit a
// table's blocks goes on in the next table (ops/kernels/adam.py::pack plans
// the tables). A chunk whose five pointers are 16-byte aligned moves as
// float4, the rest element by element.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MT_LEAVES = 48;
constexpr int MT_BLOCKS = 320;
constexpr int MT_CHUNK = 4096;
constexpr int MT_THREADS = 256;

// The launch table, laid out as ops/kernels/adam.py fills it.
struct Table {
  float* p[MT_LEAVES];
  const float* g[MT_LEAVES];
  float* mu[MT_LEAVES];
  float* nu[MT_LEAVES];
  float* nu_max[MT_LEAVES];
  long long numel[MT_LEAVES];
  int block_chunk[MT_BLOCKS];
  unsigned char block_leaf[MT_BLOCKS];
};
static_assert(sizeof(Table) == (48 * MT_LEAVES + 5 * MT_BLOCKS + 7) / 8 * 8,
              "the table's layout is ops/kernels/adam.py's");

// The update's f32 constants (the flags: bit 0 L2 decay, bit 1 adamw's
// decoupled decay, bit 2 the plateau scale).
struct Scalars {
  float b1, c1, b2, c2, inv_bc1, inv_bc2, eps, wd, neg_lr, scale;
  int flags;
};
static_assert(sizeof(Table) + sizeof(Scalars) <= 4096,
              "a launch's parameters fit 4 KB");

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ void update(float& p, float g, float& mu,
                                       float& nu, float& nu_max,
                                       const Scalars& s) {
  if (s.flags & 1) g = __fadd_rn(g, __fmul_rn(p, s.wd));
  mu = __fadd_rn(__fmul_rn(g, s.c1), __fmul_rn(mu, s.b1));
  nu = __fadd_rn(__fmul_rn(__fmul_rn(g, g), s.c2), __fmul_rn(nu, s.b2));
  const float mu_hat = __fmul_rn(mu, s.inv_bc1);
  nu_max = max_nan(nu_max, __fmul_rn(nu, s.inv_bc2));
  float u = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_max), s.eps));
  if (s.flags & 2) u = __fadd_rn(u, __fmul_rn(p, s.wd));
  u = __fmul_rn(u, s.neg_lr);
  if (s.flags & 4) u = __fmul_rn(u, s.scale);
  p = __fadd_rn(p, u);
}

__global__ void __launch_bounds__(MT_THREADS)
    adam_mt_kernel(const Table t, const Scalars s) {
  const int leaf = t.block_leaf[blockIdx.x];
  const long long start =
      static_cast<long long>(t.block_chunk[blockIdx.x]) * MT_CHUNK;
  const long long left = t.numel[leaf] - start;
  const int n = static_cast<int>(left < MT_CHUNK ? left : MT_CHUNK);
  float* p = t.p[leaf] + start;
  const float* g = t.g[leaf] + start;
  float* mu = t.mu[leaf] + start;
  float* nu = t.nu[leaf] + start;
  float* nm = t.nu_max[leaf] + start;
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(nu) |
        reinterpret_cast<uintptr_t>(nm)) & 15) == 0) {
    head = n / 4 * 4;
    for (int i = threadIdx.x * 4; i < head; i += MT_THREADS * 4) {
      float4 vp = *reinterpret_cast<const float4*>(p + i);
      const float4 vg = *reinterpret_cast<const float4*>(g + i);
      float4 vm = *reinterpret_cast<const float4*>(mu + i);
      float4 vn = *reinterpret_cast<const float4*>(nu + i);
      float4 vx = *reinterpret_cast<const float4*>(nm + i);
      update(vp.x, vg.x, vm.x, vn.x, vx.x, s);
      update(vp.y, vg.y, vm.y, vn.y, vx.y, s);
      update(vp.z, vg.z, vm.z, vn.z, vx.z, s);
      update(vp.w, vg.w, vm.w, vn.w, vx.w, s);
      *reinterpret_cast<float4*>(p + i) = vp;
      *reinterpret_cast<float4*>(mu + i) = vm;
      *reinterpret_cast<float4*>(nu + i) = vn;
      *reinterpret_cast<float4*>(nm + i) = vx;
    }
  }
  for (int i = head + threadIdx.x; i < n; i += MT_THREADS) {
    float vp = p[i], vm = mu[i], vn = nu[i], vx = nm[i];
    update(vp, g[i], vm, vn, vx, s);
    p[i] = vp;
    mu[i] = vm;
    nu[i] = vn;
    nm[i] = vx;
  }
}

}  // namespace

// One launch over `n_blocks` blocks of the table at `table` (host memory,
// copied into the launch's parameters), on `stream`; the constants as
// Scalars names them. Returns the launch's cudaError_t.
extern "C" int ctunet_adam_mt(const void* table, int n_blocks, float b1,
                              float c1, float b2, float c2, float inv_bc1,
                              float inv_bc2, float eps, float wd,
                              float neg_lr, float scale, int flags,
                              int device, void* stream) {
  if (table == nullptr || n_blocks <= 0 || n_blocks > MT_BLOCKS ||
      flags < 0 || flags > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  memcpy(&t, table, sizeof(Table));
  const Scalars s{b1, c1, b2, c2, inv_bc1, inv_bc2, eps, wd, neg_lr, scale,
                  flags};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  adam_mt_kernel<<<n_blocks, MT_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(t, s);
  return static_cast<int>(cudaGetLastError());
}
