// conv3d_tc_f32: f32 Conv3D(k = 3 or 5, SAME, stride 1) + f32 bias +
// optional ReLU on the tensor cores, as an implicit GEMM of split tf32
// products (3xTF32, with the weights split exactly).
//
// Replaces, read for what they compute and not for their layout, in f32:
//   ctunet_tpu/ops/pallas/conv3d.py::conv3d_fused (k = 5: the legacy
//     family's conv units, K5),
//   ::conv3d_chain (k = 3: the training conv, forward and the input
//     gradient on flipped, channel-swapped weights, K6),
//   ::conv3d_chain_split (f32 mode: UNetSP's conv units, BN folded, K1).
// It computes, on the dense channels-last volume, any D, H, W, with zero
// padding:
//
//   out[z,y,x,o] = act(bias[o] + sum_{dz,dy,dx,i}
//                  x[z+dz-P, y+dy-P, x+dx-P, i] * w[dz,dy,dx,i,o])
//
// with P = K/2 and act = ReLU or the identity (a flag), to f32 accuracy.
//
// Split products: the input is split as a = hi + lo (+ |r| <= 2^-22 |a|)
// with hi = tf32(a), lo = tf32(a - hi) (mma.cuh::split_tf32), the weights
// on the host exactly as w = hi + mid + lo with mid = tf32(w - hi) and lo =
// w - hi - mid (at most 3 significant bits, so tf32;
// ops/kernels/conv3d.py::pack_tcf_weights), and each product taken as
// a_hi*w_hi + a_hi*w_mid + a_hi*w_lo + a_lo*w_hi on mma.sync.m16n8k8 tf32
// -> f32. The classic 3xTF32 split of w into two halves drops a residual
// of up to 2^-22 |w| in every product: within chip_smoke.py's f32
// tolerance, but at the f32 -> int8 switch of the int8 engine's f32 first
// block (whose input is 0 / 1, so its products were exact but for that
// residual) it moved enough int8 codes against cuDNN f32 to fail the
// Dice gate there; exact weights cost one product in four.
// The tensor cores round their f32 sums toward zero, a bias that grows
// with the number of sums taken in one accumulator (K^3 * Ci = 14,000 at
// the 112 -> 28 k=5 layer). So, after Ootomo & Yokota (IJHPCA 2022), the
// sums are taken outside the tensor cores: each hi*hi product of 8 terms
// goes into a zeroed fragment and is added to the f32 accumulators by
// round-to-nearest FADDs, and the corrections (2^-11 of them) are summed
// on the tensor cores in a fragment that each pipeline stage starts at
// zero and adds to the accumulators the same way. (Summing hi*hi over a
// whole stage on the tensor cores first also stayed within the tolerance
// but moved more int8 codes at that switch than the direct kernel did,
// enough to fail the gate; chip_smoke.py phase 7 counts them.)
//
// What bounds it on an H100: 2*K^3*Ci*Co operations per voxel against
// 4*(Ci+Co) bytes; the three tf32 products of 3xTF32 make the card's
// f32-accurate rate 495 / 3 = 165 TFLOP/s (this kernel takes four), whose
// ridge is ~49 flop/B. Every
// k=5 layer is above it, and so is every k=3 layer but the narrowest
// full-resolution ones (7->7: ~47 flop/B), so the bound is the 165
// TFLOP/s. mma.sync reaches a fraction of the wgmma rate; with N = 8 (Co
// = 7, 8) each A fragment feeds three products only, and the narrow layers
// are bound by shared-memory reads of A and the splitting of A.
//
// Design (tile sizes from the host-side plan, ops/kernels/conv3d.py::
// tcf_plan), as conv3d_tc.cu's with 16-byte k-groups of 4 f32 channels:
// - GEMM view: M = an output tile of TY x TX voxels of one z plane (TX 8
//   or 16, TY*TX = 64*MF, 4 warps of MF m16 fragments each); N = BN = 8*NF
//   output channels of one N tile (the grid walks the N tiles, Co padded
//   with zero weights); K = K^3 * Ci walked as stages of (dz, chunk of Cc
//   input channels), each stage K^2 * Cc/4 k-groups of 4 channels, paired
//   into the k8 of one mma. MF * NF <= 8: the plan sweep found the 4 x 4
//   tile, which the two fragment sets (acc, c_corr) would also fit in
//   registers, no faster.
// - Shared memory, a ring of 2 stages filled by cp.async: the f32 halo slab
//   of one input plane, (TY+K-1) x (TX+K-1) x Cc, and the stage's weights,
//   packed on the host as [hi, mid, lo][k-group][BN][4] (one f32 plane
//   split on the card as A is would take fewer bytes and more
//   instructions; with two planes the plan sweep found it no faster).
//   Out-of-volume voxels
//   and channels past Ci are zero-filled (src-size 0): the SAME padding,
//   with no per-tap branch. A thread fills one 16-byte slot (voxel, 4
//   channels) at a time, stepping to its next slot without divisions: Ci
//   a multiple of 4 copies 16 bytes, of 2 two 8-byte halves, odd Ci (1, 7)
//   four 4-byte copies (an f32 is always 4-byte aligned, so no register
//   path is needed). Planes outside the volume are skipped.
// - Implicit im2col: ldmatrix on 32-bit data hands lane l the word at (row
//   l/4, word l%4) of each 8x16-byte tile; with rows = voxels and 4
//   channels a row that is the tf32 A fragment of m16n8k8. Each lane hands
//   ldmatrix the address of its own row, the slab voxel of (output voxel,
//   tap) plus the channel group, from a per-stage table of tap offsets; no
//   im2col buffer exists. The slab's channel stride is an odd number of
//   16-byte words, so the 8 rows of one ldmatrix phase fall in 8 different
//   bank groups. B fragments (hi, mid, lo) come from ldmatrix on the [n][4]
//   rows and are reused across a warp's MF fragments; each A fragment is
//   loaded and split once and feeds all NF n8 tiles and all four products.
// - Epilogue: bias, ReLU flag, no rounding but f32's, the tile staged in
//   shared memory as [voxel][channel] and written out by warps along its
//   rows, so that rows of 7 or 14 channels (28 or 56 bytes a voxel) go out
//   as contiguous runs.
#include "common.cuh"
#include "mma.cuh"

using namespace ctunet;

namespace {

constexpr int TCF_WARPS = 4;
constexpr int TCF_THREADS = 32 * TCF_WARPS;

struct Params {
  const float* x;     // (D, H, W, Ci)
  const float* w;     // (n_tiles, K, chunks, 3, groups, BN, 4)
  const float* bias;  // (Co,)
  float* out;         // (D, H, W, Co)
  int D, H, W, Ci, Co, relu;
  int tx_log2, ty, tiles_x, n_tiles;
  int cc, chunks, cs, sx, sy, groups, unit;
  int slab_elems, w_elems;  // floats per stage (w_elems: the 3 planes)
};

// A thread's walk over the slab's 16-byte slots (voxel (r, c), channel
// group g of 4): slot tid first, then every TCF_THREADS-th, stepped without
// divisions.
struct SlotWalk {
  int r, c, g;     // the first slot
  int dr, dc, dg;  // TCF_THREADS slots further
};

__device__ __forceinline__ SlotWalk slot_walk(const Params& p) {
  const int c4s = p.cc / 4;
  const int v = threadIdx.x / c4s, dv = TCF_THREADS / c4s;
  return {v / p.sx, v % p.sx, static_cast<int>(threadIdx.x) % c4s,
          dv / p.sx, dv % p.sx, TCF_THREADS % c4s};
}

// Stage (dz, chunk) of the block's tile: the halo slab of input plane zi
// and the stage's packed weights (3 planes), as asynchronous copies.
template <int K>
__device__ __forceinline__ void load_stage(const Params& p,
                                           const SlotWalk& walk, float* slab,
                                           float* wsm, int zi, int y0, int x0,
                                           int dz, int chunk, int nt) {
  constexpr int P = K / 2;
  const int c4s = p.cc / 4;
  const int n_slots = p.sy * p.sx * c4s;
  const int64_t plane = static_cast<int64_t>(zi) * p.H;
  int r = walk.r, c = walk.c, g = walk.g;
  for (int i = threadIdx.x; i < n_slots; i += TCF_THREADS) {
    const int yi = y0 - P + r, xi = x0 - P + c;
    const int ch = chunk * p.cc + g * 4;
    const bool in = yi >= 0 && yi < p.H && xi >= 0 && xi < p.W;
    const float* src = in ? p.x + ((plane + yi) * p.W + xi) * p.Ci + ch : p.x;
    const uint32_t d = smem_addr(slab + (r * p.sx + c) * p.cs + g * 4);
    switch (p.unit) {
      case 4:
        cp_async<16>(d, src, in && ch < p.Ci);
        break;
      case 2:
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = in && ch + 2 * j < p.Ci;
          cp_async<8>(d + 8 * j, ok ? src + 2 * j : p.x, ok);
        }
        break;
      default:
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = in && ch + j < p.Ci;
          cp_async<4>(d + 4 * j, ok ? src + j : p.x, ok);
        }
    }
    g += walk.dg;
    int carry = g >= c4s;
    g -= carry ? c4s : 0;
    c += walk.dc + carry;
    carry = c >= p.sx;
    c -= carry ? p.sx : 0;
    r += walk.dr + carry;
  }
  const float* wsrc =
      p.w + ((static_cast<int64_t>(nt) * K + dz) * p.chunks + chunk) *
                p.w_elems;
  for (int i = threadIdx.x; i < p.w_elems / 4; i += TCF_THREADS) {
    cp_async<16>(smem_addr(wsm + i * 4), wsrc + i * 4, true);
  }
}

template <int K, int MF, int NF>
__global__ void __launch_bounds__(TCF_THREADS)
conv3d_tc_f32_kernel(const Params p) {
  constexpr int P = K / 2;
  constexpr int BN = 8 * NF;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tab_bytes = (p.groups * 4 + 15) / 16 * 16;
  int* tab = reinterpret_cast<int*>(smem);
  float* buf = reinterpret_cast<float*>(smem + tab_bytes);
  const int stage_elems = p.slab_elems + p.w_elems;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x / p.n_tiles;
  const int nt = blockIdx.x - tile * p.n_tiles;
  const int z = blockIdx.y;
  const int ty_i = tile / p.tiles_x, tx_i = tile - ty_i * p.tiles_x;
  const int tx = 1 << p.tx_log2;
  const int y0 = ty_i * p.ty, x0 = tx_i * tx;

  // slab offset (floats) of each k-group: tap (dy, dx), channel group c4;
  // the pad group (odd count) reads any slab row against zero weights
  const int c4s = p.cc / 4;
  const int real_groups = K * K * c4s;
  for (int g = tid; g < p.groups; g += TCF_THREADS) {
    int off = 0;
    if (g < real_groups) {
      const int tap = g / c4s, c4 = g - tap * c4s;
      const int dy = tap / K, dx = tap - dy * K;
      off = (dy * p.sx + dx) * p.cs + c4 * 4;
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
    float* sb = buf + (s & 1) * stage_elems;
    load_stage<K>(p, walk, sb, sb + p.slab_elems, z + dz - P, y0, x0, dz,
                  chunk, nt);
  };

  const int a_half = lane >> 4;        // k-group of the lane's A row
  const int b_half = (lane >> 3) & 1;  // k-group of the lane's B row
  const uint32_t plane_bytes = 4u * static_cast<uint32_t>(p.w_elems / 3);
  fetch(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) fetch(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage s (and the tap table) visible to all
    const float* sb = buf + (s & 1) * stage_elems;
    const uint32_t a_base = smem_addr(sb);
    const uint32_t b_base = smem_addr(sb + p.slab_elems);
    float c_corr[MF][NF][4];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) c_corr[f][n][j] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < p.groups / 2; ++ks) {
      const int toff = tab[2 * ks + a_half];
      uint32_t a_hi[MF][4], a_lo[MF][4];
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        uint32_t a[4];
        ldsm_x4(a, a_base + 4u * static_cast<uint32_t>(row_off[f] + toff));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_tf32(__uint_as_float(a[j]), a_hi[f][j], a_lo[f][j]);
        }
      }
      const uint32_t brow =
          b_base + 16u * static_cast<uint32_t>((2 * ks + b_half) * BN);
      uint32_t b_hi[NF][2], b_mid[NF][2], b_lo[NF][2];
      load_b<NF>(b_hi, brow, lane);
      load_b<NF>(b_mid, brow + plane_bytes, lane);
      load_b<NF>(b_lo, brow + 2 * plane_bytes, lane);
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          mma_tf32(c_corr[f][n], a_lo[f], b_hi[n]);
          mma_tf32(c_corr[f][n], a_hi[f], b_mid[n]);
          mma_tf32(c_corr[f][n], a_hi[f], b_lo[n]);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, a_hi[f], b_hi[n]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[f][n][j] += d[j];
        }
    }
    // the stage's corrections into the accumulators, rounded to nearest
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[f][n][j] += c_corr[f][n][j];
    __syncthreads();  // every read of this buffer is done
  }
  cp_async_wait<0>();

  // epilogue: bias, ReLU, staged compactly ([m][ncol]) in the (now free)
  // stage buffers, then written out row by row
  const int n0 = nt * BN;
  const int ncol = min(BN, p.Co - n0);
  float* so = buf;
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
        if (col < ncol) so[m * ncol + col] = v0;
        if (col + 1 < ncol) so[m * ncol + col + 1] = v1;
      }
    }
  }
  __syncthreads();
  const int vy = min(p.ty, p.H - y0), vx = min(tx, p.W - x0);
  const int per_row = vx * ncol;
  const int64_t row0 = (static_cast<int64_t>(z) * p.H + y0) * p.W + x0;
  for (int my = warp; my < vy; my += TCF_WARPS) {
    const float* srow = so + my * tx * ncol;
    if (ncol == p.Co) {  // one N tile: the row is one contiguous run
      float* grow = p.out + (row0 + static_cast<int64_t>(my) * p.W) * p.Co;
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
  const size_t stage = 4 * static_cast<size_t>(p.slab_elems + p.w_elems);
  const size_t tile =
      static_cast<size_t>(TCF_WARPS * MF * 16) * 8 * NF * sizeof(float);
  const size_t tab = static_cast<size_t>(p.groups * 4 + 15) / 16 * 16;
  const size_t smem = tab + (2 * stage > tile ? 2 * stage : tile);
  if (smem > kMaxSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(conv3d_tc_f32_kernel<K, MF, NF>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch's check
    return static_cast<int>(err);
  }
  const int tiles_y = (p.H + p.ty - 1) / p.ty;
  const dim3 grid(static_cast<unsigned>(tiles_y * p.tiles_x * p.n_tiles),
                  static_cast<unsigned>(p.D));
  conv3d_tc_f32_kernel<K, MF, NF>
      <<<grid, TCF_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// MF * NF <= 8: (2, 1), (2, 2), (2, 4), (4, 1), (4, 2)
template <int K>
int dispatch(const Params& p, int mf, int nf, int device, void* stream) {
  switch (mf * 8 + nf) {
    case 2 * 8 + 1:
      return launch<K, 2, 1>(p, device, stream);
    case 2 * 8 + 2:
      return launch<K, 2, 2>(p, device, stream);
    case 2 * 8 + 4:
      return launch<K, 2, 4>(p, device, stream);
    case 4 * 8 + 1:
      return launch<K, 4, 1>(p, device, stream);
    case 4 * 8 + 2:
      return launch<K, 4, 2>(p, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (D,H,W,Ci) f32, w packed by ops/kernels/conv3d.py::pack_tcf_weights
// for the same (k, nf, cc, chunks), bias (Co,) f32, out (D,H,W,Co) f32.
// Returns cudaErrorInvalidValue for a plan it does not take.
extern "C" int ctunet_conv3d_tc_f32(const void* x, const void* w,
                                    const void* bias, void* out, int D, int H,
                                    int W, int Ci, int Co, int k, int relu,
                                    int mf, int nf, int tx_log2, int cc,
                                    int chunks, int device, void* stream) {
  if ((k != 3 && k != 5) || (tx_log2 != 3 && tx_log2 != 4) || cc <= 0 ||
      cc % 4 != 0 || chunks * cc < Ci || D <= 0 || H <= 0 || W <= 0 ||
      Ci <= 0 || Co <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.D = D;
  p.H = H;
  p.W = W;
  p.Ci = Ci;
  p.Co = Co;
  p.relu = relu;
  p.tx_log2 = tx_log2;
  p.ty = TCF_WARPS * 16 * mf >> tx_log2;
  p.tiles_x = (W + (1 << tx_log2) - 1) >> tx_log2;
  p.n_tiles = (Co + 8 * nf - 1) / (8 * nf);
  p.cc = cc;
  p.chunks = chunks;
  p.cs = (cc / 4) % 2 ? cc : cc + 4;
  p.sx = (1 << tx_log2) + k - 1;
  p.sy = p.ty + k - 1;
  p.groups = (k * k * (cc / 4) + 1) / 2 * 2;
  p.unit = Ci % 4 == 0 ? 4 : Ci % 2 == 0 ? 2 : 1;
  p.slab_elems = p.sy * p.sx * p.cs;
  p.w_elems = 3 * p.groups * 8 * nf * 4;
  return k == 3 ? dispatch<3>(p, mf, nf, device, stream)
                : dispatch<5>(p, mf, nf, device, stream);
}
