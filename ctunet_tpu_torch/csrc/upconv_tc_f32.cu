// upconv_tc_f32: the f32 stride-2 upsampling kernels on the tensor cores,
// as one implicit GEMM of split tf32 products (3xTF32, with the weights
// split exactly) from half-resolution operands.
//
// Replaces, read for what they compute and not for their layout, in f32:
//   ctunet_tpu/ops/pallas/upconv.py::upconv_fused_chain_split (f32 mode;
//     UNetSP's decoder: ConvT(k2, s2) + bias fused with the next Conv3D(k3)
//     + folded BN + ReLU, K3),
//   ctunet_tpu/ops/pallas/convt.py::conv_transpose_k2s2 (K7a) and
//     ::conv_transpose_k2s2_dual (K7b; the legacy family's ConvT(k2, s2) +
//     bias of one operand, or of the never-built concat of two).
// It computes what upconv_tc.cu computes, with f32 operands and weights,
// f32 output and no rounding but f32's: output voxel 2m+p (parity p in
// {0,1}^3) of the half-resolution voxel m is
//
//   out[2m+p, o] = act(bias[o] + sum_{t in T} (
//                    sum_i A[m+off(p,t), i] * Wa[p,t,i,o]
//                  + sum_j B[m+off(p,t), j] * Wb[p,t,j,o]
//                  + [K3] wone[p,t,o] if m+off(p,t) lies inside))
//
// K7: T = {0}, off = 0, Wa[p,0] = the ConvT weights of parity p, no act.
// K3: T = {0,1}^3, off(p,t) = p-1+t, Wa[p,t] = R[3-p-2t], the composite
// k4/s2/p1 response of ConvT o Conv (ops/kernels/upconv.py), act = ReLU;
// the ConvT bias rides a ones channel that is 1 inside the half-resolution
// volume and 0 outside, so its term wone depends on position near every
// face. Operands outside the volume are zero.
//
// Split products, as conv3d_tc_f32.cu takes them: A is split on the card
// as a = hi + lo (mma.cuh::split_tf32), the weights on the host exactly as
// w = hi + mid + lo (ops/kernels/conv3d.py::split_tf32_planes), and each
// product taken as a_hi*w_hi + a_lo*w_hi + a_hi*w_mid + a_hi*w_lo on
// mma.sync.m16n8k8 tf32 -> f32. The tensor cores round their f32 sums
// toward zero, so no long sum stays in them: each 8-term hi*hi product
// goes into a zeroed fragment and is added to the accumulators by
// round-to-nearest FADDs, and the corrections are summed per pipeline
// stage in a fragment that starts at zero and is added the same way.
//
// What bounds it on an H100: the output is 8 times the input's voxels.
// K7 does 16*Ct*Co flops per input voxel against 4*Ct + 32*Co bytes (Ct =
// Ca + Cb): 12 flop/B at (14+14)->28, 50 at (56+56)->112, 57 at 128->128;
// the f32-accurate 3xTF32 rate (495 / 3 = 165 TFLOP/s) has its ridge at
// ~49 flop/B, so the narrow K7 are bound by bytes, above all the output's
// (2.3 GB at (14+14)->28 over 224x304x304), and the widest sit at the
// ridge. K3 does 128*Ct*Co flops per half-resolution voxel against 4*Ct +
// 32*Co bytes: 75 flop/B at (14+14)->7, bound by its operations (the CUDA
// cores' 67 TFLOP/s alone cap it at 0.97 ms there; the tensor cores reach
// its bound). mma.sync reaches a fraction of the wgmma rate, and with N =
// 8 (Co = 7) each A fragment and its split feed few products; PERF.md has
// the kernel's time beside its bound at every path shape.
//
// Design (tiles from the host-side plan, ops/kernels/upsample_tc.py::
// uptcf_plan), upconv_tc.cu's with 16-byte k-groups of 4 f32 channels:
// - GEMM view: M = a tile of TY x TX half-resolution voxels of one z plane
//   (64*MF: 4 warps of MF m16 fragments); N = BN = 8*NF output channels of
//   one N tile, for each of the block's NP parities (K3: 2 or 4 of one pz,
//   which read the same two input planes; K7: 2, 4 or 8; the grid walks
//   parity groups and N tiles); K = input channels in stages of (input
//   plane, channel chunk of Cc, a multiple of 8: one k8 product takes two
//   k-groups).
// - One halo slab per stage, shared by all the block's parities: the
//   (TY+2) x (TX+2) x Cc slab of plane z+dz (K7: TY x TX of plane z, no
//   halo), filled by cp.async with zero-fill (src-size 0) outside the
//   volume and past the operand's channels: C a multiple of 4 copies 16
//   bytes, 2 mod 4 two 8-byte halves, odd C four 4-byte words. The slab's
//   channel stride is an odd number of 16-byte words, so the 8 rows of one
//   ldmatrix phase fall in 8 different bank groups. ldmatrix on 32-bit
//   data hands lane l the word at (row l/4, word l%4) of each 8x16-byte
//   tile: with rows = voxels that is the tf32 A fragment. The A fragment
//   of slab offset (dz, dy, dx) is loaded and split once and fed to every
//   parity that reads that offset (K3: 32/18 ~ 1.8 parities an offset at
//   NP = 4, 16/12 at NP = 2; K7: all).
//   (Splitting the whole slab once per stage into a hi and a lo plane
//   instead, an extra pass and barrier, was slower at every path shape.)
// - Two operands are two ranges of K through two pointers: the chunks of A
//   then the chunks of B (whose channel 0 is B's own). K7a is Cb = 0. The
//   concat is never built.
// - Weights are packed once on the host per (parity group, N tile, plane,
//   chunk) as the stage's slots [parity][tap (ty, tx) (K3)][hi, mid, lo]
//   [k-group][BN][4]. Which parity reads which slab offset through which
//   slot is known when the kernel is compiled (k3_slot), so the loop over
//   a stage's offsets and parities is unrolled into straight-line code
//   whose NP * MF * NF sums interleave. (A first form looked the slots up
//   in a per-block table and branched on each parity: its product chains
//   could not interleave across parities, and it was slower at every path
//   shape.)
// - Epilogue: bias, the K3 ones-channel term (the sum of wone over the
//   in-bounds taps: a precomputed full sum inside the volume, tap by tap
//   at the faces, exact at every face, edge and corner), ReLU flag; the
//   depth-to-space happens in shared memory, which stages the 2TY x 2TX
//   full-resolution rows of the block's output planes, and warps write
//   each row as one contiguous run (16-byte stores where it is aligned),
//   so rows of 7, 14 or 28 channels (28, 56 or 112 bytes a voxel) leave
//   whole instead of convt.cu's strided 32-byte pieces.
#include "common.cuh"
#include "mma.cuh"

using namespace ctunet;

namespace {

constexpr int UF_WARPS = 4;
constexpr int UF_THREADS = 32 * UF_WARPS;
// n8 x m16 fragments a warp holds per parity set (np * mf * nf): the
// accumulators and the stage's corrections take 8 floats a thread each. A
// plan sweep on the H100 found 16 slower at every path shape (fewer blocks
// on an SM).
constexpr int UF_MAX_TILES = 8;

struct Params {
  const float* a;     // (D2, H2, W2, Ca)
  const float* b;     // (D2, H2, W2, Cb) or null
  const float* w;     // (n_pg, n_tiles, n_dz, chunks, slots, 3, Cc/4, BN, 4)
  const float* wone;  // (8, 9, Co): per parity, per tap, then the sum
  const float* bias;  // (Co,)
  float* out;         // (2*D2, 2*H2, 2*W2, Co)
  int D2, H2, W2, Ca, Cb, Co, relu;
  int tx_log2, ty, tiles_x, n_tiles, n_pg, n_dz;
  int cc, chunks_a, chunks, cs, sx, sy, unit_a, unit_b;
  int slab_elems, w_elems;  // floats: the slab, and the widest stage's
                            // weights (slots * 3 * Cc * BN)
};

// K3's parity j of the block (NP = 2 or 4: one pz, every parity reads
// both input planes) reads slab offset (oy, ox), its rows counted from the
// block's py for NP = 2, through tap (ty, tx) = (oy - py_j, ox - px_j) if
// that lies in {0,1}^2; its weights are the stage's slot 4 j + 2 ty + tx
// (ops/kernels/upsample_tc.py::uptcf_slots), or -1. With the loops over
// offsets and parities unrolled this folds to constants: the product loop
// has no branch, and the parities' sums interleave.
template <int NP>
__device__ __forceinline__ constexpr int k3_slot(int oy, int ox, int j) {
  const int ty = oy - (NP == 4 ? (j >> 1) & 1 : 0), tx = ox - (j & 1);
  return ty < 0 || ty > 1 || tx < 0 || tx > 1 ? -1 : 4 * j + 2 * ty + tx;
}

// A thread's walk over the slab's 16-byte slots (voxel (r, c), channel
// group g of 4): slot tid first, then every UF_THREADS-th, stepped without
// divisions.
struct SlotWalk {
  int r, c, g;
  int dr, dc, dg;
};

__device__ __forceinline__ SlotWalk slot_walk(const Params& p) {
  const int c4s = p.cc / 4;
  const int v = threadIdx.x / c4s, dv = UF_THREADS / c4s;
  return {v / p.sx, v % p.sx, static_cast<int>(threadIdx.x) % c4s,
          dv / p.sx, dv % p.sx, UF_THREADS % c4s};
}

// Stage (plane zi, channel chunk of operand src with C channels from ch0):
// the slab at (y0 - H, x0 - H) and n_w weight floats, as asynchronous
// copies.
template <int H>
__device__ __forceinline__ void load_stage(
    const Params& p, const SlotWalk& walk, float* slab, float* wsm,
    const float* src0, int C, int ch0, int unit, int zi, int y0, int x0,
    const float* wsrc, int n_w) {
  const int c4s = p.cc / 4;
  const int n_slab = p.sy * p.sx * c4s;
  const int64_t plane = static_cast<int64_t>(zi) * p.H2;
  int r = walk.r, c = walk.c, g = walk.g;
  for (int i = threadIdx.x; i < n_slab; i += UF_THREADS) {
    const int yi = y0 - H + r, xi = x0 - H + c;
    const int ch = ch0 + g * 4;
    const bool in = yi >= 0 && yi < p.H2 && xi >= 0 && xi < p.W2;
    const float* src = in ? src0 + ((plane + yi) * p.W2 + xi) * C + ch : src0;
    const uint32_t d = smem_addr(slab + (r * p.sx + c) * p.cs + g * 4);
    switch (unit) {
      case 4:
        cp_async<16>(d, src, in && ch < C);
        break;
      case 2:
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = in && ch + 2 * j < C;
          cp_async<8>(d + 8 * j, ok ? src + 2 * j : src0, ok);
        }
        break;
      default:
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = in && ch + j < C;
          cp_async<4>(d + 4 * j, ok ? src + j : src0, ok);
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
  for (int i = threadIdx.x; i < n_w / 4; i += UF_THREADS) {
    cp_async<16>(smem_addr(wsm + i * 4), wsrc + i * 4, true);
  }
}

template <int H, int NP, int MF, int NF>
__global__ void __launch_bounds__(UF_THREADS)
upconv_tc_f32_kernel(const Params p) {
  static_assert(H == 0 || NP == 2 || NP == 4, "K3 takes 2 or 4 parities");
  constexpr int BN = 8 * NF;
  // slab offsets a block reads: K3 3 x 3 (NP = 4) or 2 x 3 rows from its
  // py (NP = 2); K7 one
  constexpr int NOY = H ? (NP == 4 ? 3 : 2) : 1, NOX = H ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  const int stage_elems = p.slab_elems + p.w_elems;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int bx = blockIdx.x;
  const int nt = bx % p.n_tiles;
  bx /= p.n_tiles;
  const int pg = bx % p.n_pg;
  const int tile = bx / p.n_pg;
  const int z = blockIdx.y;
  const int ty_i = tile / p.tiles_x, tx_i = tile - ty_i * p.tiles_x;
  const int tx = 1 << p.tx_log2;
  const int y0 = ty_i * p.ty, x0 = tx_i * tx;
  const int p0 = pg * NP;
  const int pz_lo = p0 >> 2;
  const int dz_lo = H ? pz_lo - 1 : 0;
  const int oy0 = H ? (p0 >> 1) & 1 : 0;  // the block's py (NP = 2), or 0

  // each lane's A row: voxel (lane & 15) of the warp's m16 fragment f
  int row_off[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    const int m = (warp * MF + f) * 16 + (lane & 15);
    const int my = m >> p.tx_log2, mx = m & (tx - 1);
    row_off[f] = (my * p.sx + mx) * p.cs;
  }

  float acc[NP][MF][NF][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][f][n][e] = 0.f;

  // planes z + dz_lo + dzi inside the volume
  const int dzi_lo = max(0, -(z + dz_lo));
  const int dzi_hi = min(p.n_dz, p.D2 - z - dz_lo);
  const int n_stages = max(0, dzi_hi - dzi_lo) * p.chunks;
  const SlotWalk walk = slot_walk(p);
  const int64_t w_block =
      (static_cast<int64_t>(pg) * p.n_tiles + nt) * p.n_dz;
  auto fetch = [&](int s) {
    const int dzi = dzi_lo + s / p.chunks, chunk = s % p.chunks;
    float* sb = buf + (s & 1) * stage_elems;
    const bool in_a = chunk < p.chunks_a;
    const float* wsrc =
        p.w + ((w_block + dzi) * p.chunks + chunk) * p.w_elems;
    load_stage<H>(p, walk, sb, sb + p.slab_elems, in_a ? p.a : p.b,
                  in_a ? p.Ca : p.Cb,
                  (in_a ? chunk : chunk - p.chunks_a) * p.cc,
                  in_a ? p.unit_a : p.unit_b, z + dz_lo + dzi, y0, x0, wsrc,
                  p.w_elems);
  };

  const int a_half = lane >> 4;        // k-group of the lane's A row
  const int b_half = (lane >> 3) & 1;  // k-group of the lane's B row
  const int c4s = p.cc / 4;
  // bytes between a slot's weight planes, and between two slots
  const uint32_t plane_bytes = 4u * static_cast<uint32_t>(p.cc * BN);
  const uint32_t slot_bytes = 3u * plane_bytes;
  if (n_stages > 0) fetch(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) fetch(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage s visible to all
    const float* sb = buf + (s & 1) * stage_elems;
    const uint32_t a_base = smem_addr(sb);
    const uint32_t b_base = smem_addr(sb + p.slab_elems);
    float c_corr[NP][MF][NF][4];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c_corr[j][f][n][e] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < c4s / 2; ++ks) {
#pragma unroll
      for (int o = 0; o < NOY * NOX; ++o) {
        const int oy = o / NOX, ox = o % NOX;
        bool read = false;
#pragma unroll
        for (int j = 0; j < NP; ++j) read |= !H || k3_slot<NP>(oy, ox, j) >= 0;
        if (!read) continue;
        const int off = H ? ((oy + oy0) * p.sx + ox) * p.cs : 0;
        uint32_t a_hi[MF][4], a_lo[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          uint32_t a[4];
          ldsm_x4(a, a_base + 4u * static_cast<uint32_t>(
                                      row_off[f] + off +
                                      (2 * ks + a_half) * 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split_tf32(__uint_as_float(a[e]), a_hi[f][e], a_lo[f][e]);
          }
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int sl = H ? k3_slot<NP>(oy, ox, j) : j;
          if (sl < 0) continue;
          const uint32_t brow =
              b_base + slot_bytes * static_cast<uint32_t>(sl) +
              16u * static_cast<uint32_t>((2 * ks + b_half) * BN);
          uint32_t b_hi[NF][2], b_mid[NF][2], b_lo[NF][2];
          load_b<NF>(b_hi, brow, lane);
          load_b<NF>(b_mid, brow + plane_bytes, lane);
          load_b<NF>(b_lo, brow + 2 * plane_bytes, lane);
#pragma unroll
          for (int f = 0; f < MF; ++f)
#pragma unroll
            for (int n = 0; n < NF; ++n) {
              mma_tf32(c_corr[j][f][n], a_lo[f], b_hi[n]);
              mma_tf32(c_corr[j][f][n], a_hi[f], b_mid[n]);
              mma_tf32(c_corr[j][f][n], a_hi[f], b_lo[n]);
              float d[4];
              mma_tf32_zero(d, a_hi[f], b_hi[n]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][f][n][e] += d[e];
            }
        }
      }
    }
    // the stage's corrections into the accumulators, rounded to nearest
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][f][n][e] += c_corr[j][f][n][e];
    __syncthreads();  // every read of this buffer is done
  }
  cp_async_wait<0>();

  // epilogue: bias, ones-channel term, ReLU, staged as full-resolution
  // rows [zl][my][yl][2*mx + px][ncol] in the free stage buffers
  const int n0 = nt * BN;
  const int ncol = min(BN, p.Co - n0);
  constexpr int NY = NP >= 4 ? 2 : 1;
  const int row_len = 2 * tx * ncol;
  float* so = buf;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int par = p0 + j;
    const int pz = par >> 2, py = (par >> 1) & 1, px = par & 1;
    const int zl = NP == 8 ? pz : 0, yl = NP >= 4 ? py : 0;
    // the K3 tap that falls outside in each dimension at a face: tap pd
    // (u = m - 1 for parity 0, m + 1 for parity 1)
    const bool fz = H && (pz ? z == p.D2 - 1 : z == 0);
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      const float b0 = col < ncol ? p.bias[n0 + col] : 0.f;
      const float b1 = col + 1 < ncol ? p.bias[n0 + col + 1] : 0.f;
#pragma unroll
      for (int f = 0; f < MF; ++f) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = (warp * MF + f) * 16 + (lane >> 2) + hh * 8;
          const int my = m >> p.tx_log2, mx = m & (tx - 1);
          float v0 = acc[j][f][n][2 * hh] + b0;
          float v1 = acc[j][f][n][2 * hh + 1] + b1;
          if (H) {
            const int yy = y0 + my, xx = x0 + mx;
            const bool fy = py ? yy == p.H2 - 1 : yy == 0;
            const bool fx = px ? xx == p.W2 - 1 : xx == 0;
            const float* wo = p.wone + static_cast<int64_t>(par) * 9 * p.Co +
                              n0 + col;
            if (!(fz || fy || fx)) {
              if (col < ncol) v0 += wo[8 * p.Co];
              if (col + 1 < ncol) v1 += wo[8 * p.Co + 1];
            } else {
              for (int t = 0; t < 8; ++t) {
                if ((fz && (t >> 2) == pz) || (fy && ((t >> 1) & 1) == py) ||
                    (fx && (t & 1) == px))
                  continue;
                if (col < ncol) v0 += wo[t * p.Co];
                if (col + 1 < ncol) v1 += wo[t * p.Co + 1];
              }
            }
          }
          if (p.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const int idx =
              (((zl * p.ty + my) * NY + yl) * 2 * tx + 2 * mx + px) * ncol +
              col;
          if (col < ncol) so[idx] = v0;
          if (col + 1 < ncol) so[idx + 1] = v1;
        }
      }
    }
  }
  __syncthreads();
  const int vy = min(p.ty, p.H2 - y0), vx = min(tx, p.W2 - x0);
  const int per_row = 2 * vx * ncol;
  const int n_rows = (NP == 8 ? 2 : 1) * p.ty * NY;
  const int ho = 2 * p.H2, wo = 2 * p.W2;
  for (int r = warp; r < n_rows; r += UF_WARPS) {
    const int yl = NY == 2 ? (r & 1) : 0;
    const int rz = NY == 2 ? r >> 1 : r;
    const int zl = rz / p.ty, my = rz - zl * p.ty;
    if (my >= vy) continue;
    const int zo = 2 * z + (NP == 8 ? zl : pz_lo);
    const int yo = 2 * (y0 + my) + (NP >= 4 ? yl : (p0 >> 1) & 1);
    const int64_t vox = (static_cast<int64_t>(zo) * ho + yo) * wo + 2 * x0;
    const float* srow = so + r * row_len;
    if (ncol == p.Co) {  // one N tile: the row is one contiguous run
      float* grow = p.out + vox * p.Co;
      int e0 = 0;
      if ((reinterpret_cast<uintptr_t>(grow) & 15) == 0) {
        const int nv = per_row / 4;  // srow is 16-byte aligned: 2*tx >= 16
        for (int e = lane; e < nv; e += 32) {
          reinterpret_cast<float4*>(grow)[e] =
              reinterpret_cast<const float4*>(srow)[e];
        }
        e0 = nv * 4;
      }
      for (int e = e0 + lane; e < per_row; e += 32) grow[e] = srow[e];
    } else {
      for (int e = lane; e < per_row; e += 32) {
        const int v = e / ncol, c = e - v * ncol;
        p.out[(vox + v) * p.Co + n0 + c] = srow[e];
      }
    }
  }
}

template <int H, int NP, int MF, int NF>
int launch(const Params& p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t stage = 4 * static_cast<size_t>(p.slab_elems + p.w_elems);
  const size_t tile = static_cast<size_t>(NP) * UF_WARPS * MF * 16 * 8 * NF *
                      sizeof(float);
  const size_t smem = 2 * stage > tile ? 2 * stage : tile;
  if (smem > kMaxSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(upconv_tc_f32_kernel<H, NP, MF, NF>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch's check
    return static_cast<int>(err);
  }
  const int tiles_y = (p.H2 + p.ty - 1) / p.ty;
  const dim3 grid(
      static_cast<unsigned>(tiles_y * p.tiles_x * p.n_pg * p.n_tiles),
      static_cast<unsigned>(p.D2));
  upconv_tc_f32_kernel<H, NP, MF, NF>
      <<<grid, UF_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// NP * MF * NF <= UF_MAX_TILES
template <int H, int NP, int MF>
int dispatch_nf(const Params& p, int nf, int device, void* stream) {
  if constexpr (NP * MF * 4 <= UF_MAX_TILES) {
    if (nf == 4) return launch<H, NP, MF, 4>(p, device, stream);
  }
  if constexpr (NP * MF * 2 <= UF_MAX_TILES) {
    if (nf == 2) return launch<H, NP, MF, 2>(p, device, stream);
  }
  if (nf == 1) return launch<H, NP, MF, 1>(p, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int H, int NP>
int dispatch_mf(const Params& p, int mf, int nf, int device, void* stream) {
  if constexpr (NP * 2 <= UF_MAX_TILES) {
    if (mf == 2) return dispatch_nf<H, NP, 2>(p, nf, device, stream);
  }
  if (mf == 1) return dispatch_nf<H, NP, 1>(p, nf, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int H>
int dispatch_np(const Params& p, int np, int mf, int nf, int device,
                void* stream) {
  switch (np) {
    case 2:
      return dispatch_mf<H, 2>(p, mf, nf, device, stream);
    case 4:
      return dispatch_mf<H, 4>(p, mf, nf, device, stream);
    case 8:
      if constexpr (H == 0) {
        return dispatch_mf<H, 8>(p, mf, nf, device, stream);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int copy_unit(int c) { return c % 4 == 0 ? 4 : c % 2 == 0 ? 2 : 1; }

}  // namespace

// a (D2,H2,W2,Ca) and b (D2,H2,W2,Cb) f32 (b null and Cb 0 for one
// operand), w packed by ops/kernels/upsample_tc.py::pack_weights_f32 for
// the same (k3, np, nf, cc, chunks_a, chunks_b), wone (8, 9, Co) f32 (K3
// only, else null), bias (Co,) f32, out (2*D2, 2*H2, 2*W2, Co) f32. k3 =
// 1: the K3 function (8 taps a parity, halo, ones term; np 2 or 4); 0: K7
// (np 2, 4 or 8). Returns cudaErrorInvalidValue for a plan it does not
// take.
extern "C" int ctunet_upconv_tc_f32(const void* a, const void* b,
                                    const void* w, const void* wone,
                                    const void* bias, void* out, int D2,
                                    int H2, int W2, int Ca, int Cb, int Co,
                                    int k3, int relu, int np, int mf, int nf,
                                    int tx_log2, int cc, int chunks_a,
                                    int chunks_b, int device, void* stream) {
  if ((tx_log2 != 3 && tx_log2 != 4) || cc <= 0 || cc % 8 != 0 ||
      chunks_a * cc < Ca || chunks_b * cc < Cb || (Cb > 0) != (b != nullptr) ||
      (Cb == 0) != (chunks_b == 0) || (k3 != 0) != (wone != nullptr) ||
      np * mf * nf > UF_MAX_TILES || D2 <= 0 || H2 <= 0 || W2 <= 0 || Ca <= 0 ||
      Co <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int h = k3 ? 1 : 0;
  Params p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.w = static_cast<const float*>(w);
  p.wone = static_cast<const float*>(wone);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.D2 = D2;
  p.H2 = H2;
  p.W2 = W2;
  p.Ca = Ca;
  p.Cb = Cb;
  p.Co = Co;
  p.relu = relu;
  p.tx_log2 = tx_log2;
  p.ty = UF_WARPS * 16 * mf >> tx_log2;
  p.tiles_x = (W2 + (1 << tx_log2) - 1) >> tx_log2;
  p.n_tiles = (Co + 8 * nf - 1) / (8 * nf);
  p.n_pg = 8 / np;
  p.n_dz = k3 ? 2 : 1;
  p.cc = cc;
  p.chunks_a = chunks_a;
  p.chunks = chunks_a + chunks_b;
  p.cs = cc + 4;  // cc / 4 is even: an odd number of 16-byte words a voxel
  p.sx = (1 << tx_log2) + 2 * h;
  p.sy = p.ty + 2 * h;
  p.unit_a = copy_unit(Ca);
  p.unit_b = Cb > 0 ? copy_unit(Cb) : 4;
  const int slots = k3 ? 4 * np : np;  // the widest stage's
  p.slab_elems = p.sy * p.sx * p.cs;
  p.w_elems = slots * 3 * cc * 8 * nf;
  return k3 ? dispatch_np<1>(p, np, mf, nf, device, stream)
            : dispatch_np<0>(p, np, mf, nf, device, stream);
}
