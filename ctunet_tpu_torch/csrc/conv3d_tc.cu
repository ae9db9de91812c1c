// conv3d_tc: bf16 Conv3D(k = 3 or 5, SAME, stride 1) + f32 bias + optional
// ReLU on the tensor cores, as an implicit GEMM.
//
// Replaces, read for what they compute and not for their layout:
//   ctunet_tpu/ops/pallas/conv3d.py::conv3d_fused (k = 3 and k = 5; the
//     legacy k=5 family's conv units),
//   ::conv3d_chain_split (bf16 mode; UNetSP's conv units, BN folded),
//   ::conv3d_chain (the training conv: forward, and the input gradient on
//     flipped, channel-swapped weights; the `sparse` serving route).
// The TPU kernels pack W into the MXU's 128 lanes and keep halo rows and a
// ones-channel in a flat chain layout; here the function is computed on
// the dense channels-last volume, any D, H, W, with zero padding:
//
//   out[z,y,x,o] = bf16(act(bias[o] + sum_{dz,dy,dx,i}
//                  x[z+dz-P, y+dy-P, x+dx-P, i] * w[dz,dy,dx,i,o]))
//
// with P = K/2, f32 accumulation and one rounding to bf16 at the end, act
// = ReLU or the identity (a flag). f32 tensors stay on the direct kernels
// (conv3d.cu, conv3d_k5.cu): the tensor cores' f32 mode is TF32.
//
// What bounds it on an H100: 2*K^3*Ci*Co operations per voxel against
// 2*(Ci+Co) bytes. At k=5 every layer but the input convs is above the
// bf16 ridge (~295 flop/B), so the bound is the tensor cores' 989 TFLOP/s;
// the k=3 full-resolution layers (7->7: ~95 flop/B) are bound by bytes.
// mma.sync reaches a fraction of the wgmma rate, and with N = 8 (Co = 7)
// each A fragment feeds one product, so the narrow layers are bound by
// shared-memory reads of A.
//
// Design (the tile sizes come from the host-side plan, ops/kernels/
// conv3d.py::tc_plan):
// - GEMM view: M = an output tile of TY x TX voxels of one z plane (TX 8
//   or 16, TY*TX = 64*MF, 4 warps of MF m16 fragments each); N = BN = 8*NF
//   output channels of one N tile (grid walks the N tiles, Co padded with
//   zero weights); K = K^3 * Ci walked as stages of (dz, chunk of Cc input
//   channels), each stage K^2 * Cc/8 k-groups of 8 channels, paired into
//   the k16 of one mma.sync.m16n8k16 (bf16 -> f32). A pair may join two
//   taps, so Ci = 7 (padded to 8) wastes 1/8 of the products, not 9/16.
// - Shared memory, a ring of 2 stages filled by cp.async: the halo slab of
//   one input plane, (TY+K-1) x (TX+K-1) x Cc bf16, and the stage's
//   weights, packed on the host as [k-group][BN][8] bf16. Out-of-volume
//   voxels and channels past Ci are zero-filled (cp.async src-size 0): that
//   is the SAME padding, with no per-tap branch. A thread fills one
//   16-byte slot (voxel, 8 channels) at a time, stepping to its next slot
//   without divisions: Ci a multiple of 8, 4 or 2 copies 16, 8 or 4 bytes
//   at a time; odd Ci (1, 7) reads the 8 channels into registers and stores
//   them at once. Planes outside the volume are skipped. Stages are small
//   (TC_STAGE_BYTES in the plan) so that several blocks share an SM.
// - Implicit im2col: each lane hands ldmatrix the address of its own row,
//   the slab voxel of (output voxel, tap) plus the channel group, from a
//   per-stage table of tap offsets; no im2col buffer exists. The slab's
//   channel stride is an odd number of 16-byte words, so the 8 rows of one
//   ldmatrix phase fall in 8 different bank groups. B fragments come from
//   ldmatrix on the [n][8] rows and are reused across a warp's MF
//   fragments; each A fragment is reused across the NF n8 tiles.
// - Epilogue: bias, ReLU flag, one rounding to bf16, the tile staged in
//   shared memory as [voxel][channel] and written out by warps along its
//   rows, so that rows of 7 or 14 channels (14 or 28 bytes a voxel) go out
//   as contiguous runs.
#include "common.cuh"
#include "mma.cuh"

using namespace ctunet;

namespace {

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;

struct Params {
  const __nv_bfloat16* x;  // (D, H, W, Ci)
  const __nv_bfloat16* w;  // (n_tiles, K, chunks, groups, BN, 8)
  const float* bias;       // (Co,)
  __nv_bfloat16* out;      // (D, H, W, Co)
  int D, H, W, Ci, Co, relu;
  int tx_log2, ty, tiles_x, n_tiles;
  int cc, chunks, cs, sx, sy, groups, unit;
  int slab_elems, w_elems;  // bf16 elements per stage
};

// A thread's walk over the slab's 16-byte slots (voxel (r, c), channel
// group g of 8): slot tid first, then every TC_THREADS-th, stepped without
// divisions.
struct SlotWalk {
  int r, c, g;     // the first slot
  int dr, dc, dg;  // TC_THREADS slots further
};

__device__ __forceinline__ SlotWalk slot_walk(const Params& p) {
  const int c8s = p.cc / 8;
  const int v = threadIdx.x / c8s, dv = TC_THREADS / c8s;
  return {v / p.sx, v % p.sx, static_cast<int>(threadIdx.x) % c8s,
          dv / p.sx, dv % p.sx, TC_THREADS % c8s};
}

// Stage (dz, chunk) of the block's tile: the halo slab of input plane zi
// and the stage's packed weights, as asynchronous copies (odd Ci is read
// element by element into registers and stored 16 bytes at a time,
// published by the same barrier).
template <int K>
__device__ __forceinline__ void load_stage(const Params& p,
                                           const SlotWalk& walk,
                                           __nv_bfloat16* slab,
                                           __nv_bfloat16* wsm, int zi, int y0,
                                           int x0, int dz, int chunk, int nt) {
  constexpr int P = K / 2;
  const int c8s = p.cc / 8;
  const int n_slots = p.sy * p.sx * c8s;
  const int64_t plane = static_cast<int64_t>(zi) * p.H;
  int r = walk.r, c = walk.c, g = walk.g;
  for (int i = threadIdx.x; i < n_slots; i += TC_THREADS) {
    const int yi = y0 - P + r, xi = x0 - P + c;
    const int ch = chunk * p.cc + g * 8;
    const bool in = yi >= 0 && yi < p.H && xi >= 0 && xi < p.W;
    const __nv_bfloat16* src =
        in ? p.x + ((plane + yi) * p.W + xi) * p.Ci + ch : p.x;
    __nv_bfloat16* dst = slab + (r * p.sx + c) * p.cs + g * 8;
    const uint32_t d = smem_addr(dst);
    switch (p.unit) {
      case 8:
        cp_async<16>(d, src, in && ch < p.Ci);
        break;
      case 4:
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = in && ch + 4 * j < p.Ci;
          cp_async<8>(d + 8 * j, ok ? src + 4 * j : p.x, ok);
        }
        break;
      case 2:
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = in && ch + 2 * j < p.Ci;
          cp_async<4>(d + 4 * j, ok ? src + 2 * j : p.x, ok);
        }
        break;
      default: {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        uint4 q;
        q.x = ld_pair(s16, in && ch < p.Ci, in && ch + 1 < p.Ci);
        q.y = ld_pair(s16 + 2, in && ch + 2 < p.Ci, in && ch + 3 < p.Ci);
        q.z = ld_pair(s16 + 4, in && ch + 4 < p.Ci, in && ch + 5 < p.Ci);
        q.w = ld_pair(s16 + 6, in && ch + 6 < p.Ci, in && ch + 7 < p.Ci);
        *reinterpret_cast<uint4*>(dst) = q;
      }
    }
    g += walk.dg;
    int carry = g >= c8s;
    g -= carry ? c8s : 0;
    c += walk.dc + carry;
    carry = c >= p.sx;
    c -= carry ? p.sx : 0;
    r += walk.dr + carry;
  }
  const __nv_bfloat16* wsrc =
      p.w + ((static_cast<int64_t>(nt) * K + dz) * p.chunks + chunk) *
                p.w_elems;
  for (int i = threadIdx.x; i < p.w_elems / 8; i += TC_THREADS) {
    cp_async<16>(smem_addr(wsm + i * 8), wsrc + i * 8, true);
  }
}

template <int K, int MF, int NF>
__global__ void __launch_bounds__(TC_THREADS)
conv3d_tc_kernel(const Params p) {
  constexpr int P = K / 2;
  constexpr int BN = 8 * NF;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tab_bytes = (p.groups * 4 + 15) / 16 * 16;
  int* tab = reinterpret_cast<int*>(smem);
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem + tab_bytes);
  const int stage_elems = p.slab_elems + p.w_elems;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x / p.n_tiles;
  const int nt = blockIdx.x - tile * p.n_tiles;
  const int z = blockIdx.y;
  const int ty_i = tile / p.tiles_x, tx_i = tile - ty_i * p.tiles_x;
  const int tx = 1 << p.tx_log2;
  const int y0 = ty_i * p.ty, x0 = tx_i * tx;

  // slab offset (elements) of each k-group: tap (dy, dx), channel group c8;
  // the pad group (odd count) reads any slab row against zero weights
  const int c8s = p.cc / 8;
  const int real_groups = K * K * c8s;
  for (int g = tid; g < p.groups; g += TC_THREADS) {
    int off = 0;
    if (g < real_groups) {
      const int tap = g / c8s, c8 = g - tap * c8s;
      const int dy = tap / K, dx = tap - dy * K;
      off = (dy * p.sx + dx) * p.cs + c8 * 8;
    }
    tab[g] = off;
  }

  // each lane's A row: voxel (lane & 15) of the warp's m16 fragment f
  int row_off[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    const int m = (warp * MF + f) * 16 + (lane & 15);
    const int my = m >> p.tx_log2, mx = m & (tx - 1);
    row_off[f] = (my * p.sx + mx) * p.cs;
  }

  float acc[MF][NF][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f][n][j] = 0.f;

  const int dz_lo = max(0, P - z), dz_hi = min(K, p.D + P - z);
  const int n_stages = (dz_hi - dz_lo) * p.chunks;
  const SlotWalk walk = slot_walk(p);
  auto fetch = [&](int s) {
    const int dz = dz_lo + s / p.chunks, chunk = s % p.chunks;
    __nv_bfloat16* sb = buf + (s & 1) * stage_elems;
    load_stage<K>(p, walk, sb, sb + p.slab_elems, z + dz - P, y0, x0, dz,
                  chunk, nt);
  };

  const int a_half = lane >> 4;        // k-group of the lane's A row
  const int b_half = (lane >> 3) & 1;  // k-group of the lane's B row
  fetch(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) fetch(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage s (and the tap table) visible to all
    const __nv_bfloat16* sb = buf + (s & 1) * stage_elems;
    const uint32_t a_base = smem_addr(sb);
    const uint32_t b_base = smem_addr(sb + p.slab_elems);
#pragma unroll 2
    for (int ks = 0; ks < p.groups / 2; ++ks) {
      const int toff = tab[2 * ks + a_half];
      uint32_t a[MF][4];
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        ldsm_x4(a[f], a_base + 2u * static_cast<uint32_t>(row_off[f] + toff));
      }
      uint32_t b[NF][2];
      load_b<NF>(b, b_base + 16u * static_cast<uint32_t>((2 * ks + b_half) *
                                                         BN),
                 lane);
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int n = 0; n < NF; ++n) mma_bf16(acc[f][n], a[f], b[n]);
    }
    __syncthreads();  // every read of this buffer is done
  }
  cp_async_wait<0>();

  // epilogue: bias, ReLU, bf16, staged compactly ([m][ncol]) in the (now
  // free) stage buffers, then written out row by row
  const int n0 = nt * BN;
  const int ncol = min(BN, p.Co - n0);
  __nv_bfloat16* so = buf;
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    const int col = n * 8 + (lane & 3) * 2;
    const float b0 = col < ncol ? p.bias[n0 + col] : 0.f;
    const float b1 = col + 1 < ncol ? p.bias[n0 + col + 1] : 0.f;
#pragma unroll
    for (int f = 0; f < MF; ++f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (warp * MF + f) * 16 + (lane >> 2) + h * 8;
        float v0 = acc[f][n][2 * h] + b0, v1 = acc[f][n][2 * h + 1] + b1;
        if (p.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (col < ncol) so[m * ncol + col] = __float2bfloat16(v0);
        if (col + 1 < ncol) so[m * ncol + col + 1] = __float2bfloat16(v1);
      }
    }
  }
  __syncthreads();
  const int vy = min(p.ty, p.H - y0), vx = min(tx, p.W - x0);
  const int per_row = vx * ncol;
  const int64_t row0 = (static_cast<int64_t>(z) * p.H + y0) * p.W + x0;
  for (int my = warp; my < vy; my += TC_WARPS) {
    const __nv_bfloat16* srow = so + my * tx * ncol;
    if (ncol == p.Co) {  // one N tile: the row is one contiguous run
      __nv_bfloat16* grow = p.out + (row0 + static_cast<int64_t>(my) * p.W) *
                                        p.Co;
      for (int e = lane; e < per_row; e += 32) grow[e] = srow[e];
    } else {
      for (int e = lane; e < per_row; e += 32) {
        const int mx = e / ncol, j = e - mx * ncol;
        p.out[(row0 + static_cast<int64_t>(my) * p.W + mx) * p.Co + n0 + j] =
            srow[e];
      }
    }
  }
}

template <int K, int MF, int NF>
int launch(const Params& p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t stage = 2 * static_cast<size_t>(p.slab_elems + p.w_elems);
  const size_t tile =
      static_cast<size_t>(TC_WARPS * MF * 16) * 8 * NF * sizeof(__nv_bfloat16);
  const size_t tab = static_cast<size_t>(p.groups * 4 + 15) / 16 * 16;
  const size_t smem = tab + (2 * stage > tile ? 2 * stage : tile);
  if (smem > kMaxSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(conv3d_tc_kernel<K, MF, NF>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch's check
    return static_cast<int>(err);
  }
  const int tiles_y = (p.H + p.ty - 1) / p.ty;
  const dim3 grid(static_cast<unsigned>(tiles_y * p.tiles_x * p.n_tiles),
                  static_cast<unsigned>(p.D));
  conv3d_tc_kernel<K, MF, NF>
      <<<grid, TC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int MF>
int dispatch_nf(const Params& p, int nf, int device, void* stream) {
  switch (nf) {
    case 1:
      return launch<K, MF, 1>(p, device, stream);
    case 2:
      return launch<K, MF, 2>(p, device, stream);
    case 4:
      return launch<K, MF, 4>(p, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int K>
int dispatch_mf(const Params& p, int mf, int nf, int device, void* stream) {
  switch (mf) {
    case 2:
      return dispatch_nf<K, 2>(p, nf, device, stream);
    case 4:
      return dispatch_nf<K, 4>(p, nf, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (D,H,W,Ci) bf16, w packed by ops/kernels/conv3d.py::pack_tc_weights
// for the same (k, mf, nf, tx_log2, cc, chunks), bias (Co,) f32, out
// (D,H,W,Co) bf16. Returns cudaErrorInvalidValue for a plan it does not
// take.
extern "C" int ctunet_conv3d_tc(const void* x, const void* w,
                                const void* bias, void* out, int D, int H,
                                int W, int Ci, int Co, int k, int relu,
                                int mf, int nf, int tx_log2, int cc,
                                int chunks, int device, void* stream) {
  if ((k != 3 && k != 5) || (tx_log2 != 3 && tx_log2 != 4) || cc <= 0 ||
      cc % 8 != 0 || chunks * cc < Ci || D <= 0 || H <= 0 || W <= 0 ||
      Ci <= 0 || Co <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.D = D;
  p.H = H;
  p.W = W;
  p.Ci = Ci;
  p.Co = Co;
  p.relu = relu;
  p.tx_log2 = tx_log2;
  p.ty = TC_WARPS * 16 * mf >> tx_log2;
  p.tiles_x = (W + (1 << tx_log2) - 1) >> tx_log2;
  p.n_tiles = (Co + 8 * nf - 1) / (8 * nf);
  p.cc = cc;
  p.chunks = chunks;
  p.cs = (cc / 8) % 2 ? cc : cc + 8;
  p.sx = (1 << tx_log2) + k - 1;
  p.sy = p.ty + k - 1;
  p.groups = (k * k * (cc / 8) + 1) / 2 * 2;
  p.unit = Ci % 8 == 0 ? 8 : Ci % 4 == 0 ? 4 : Ci % 2 == 0 ? 2 : 1;
  p.slab_elems = p.sy * p.sx * p.cs;
  p.w_elems = p.groups * 8 * nf * 8;
  return k == 3 ? dispatch_mf<3>(p, mf, nf, device, stream)
                : dispatch_mf<5>(p, mf, nf, device, stream);
}
