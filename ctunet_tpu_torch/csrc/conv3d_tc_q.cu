// conv3d_tc_q: int8 Conv3D(k3, SAME, stride 1) + requant epilogue on the
// int8 tensor cores, as an implicit GEMM.
//
// Replaces, read for what they compute and not for their layout:
//   ctunet_tpu/ops/pallas/conv3d.py::conv3d_chain_split(scale=, zp=)
//     (K1q: kernel body _chain_kernel_ring_split, epilogue :1001-1013),
//   ::conv3d_chain_q (K4a: the full-tap form, epilogue :1597-1612; also
//     its `sparse_gh` constant-region skip, which gives the same integers).
// Both compute, on the dense channels-last volume,
//
//   acc[v,o] = sum_{tap,i} q_w[tap,i,o] * x[v+tap-1, i]     (exact int32)
//   r        = relu(fma(f32(acc), scale[o], bias[o]))       (one rounding)
//   zp mode:  out = rint(min(r, 255) - 128)                 (f32 subtract)
//   symmetric: out = rint(min(r, 127))
//
// where an out-of-volume tap reads the layout's fill: -128 (the activation
// zero) in zp mode, 0 in symmetric mode. The int32 sums are exact, so any
// order of summation gives the same integers; the epilogue is the one of
// conv3d_q.cu (the CUDA-core kernel this replaces), bit for bit:
// __int2float_rn, one __fmaf_rn, fmaxf, then __fsub_rn(fminf(., 255), 128)
// or fminf(., 127), then __float2int_rn.
//
// What bounds it on an H100: 54*Ci*Co int8 operations per voxel against
// Ci + Co bytes. The full-resolution and level-1 convs (2->7 .. 14->14,
// 11-200 op/B) are bound by bytes (ridge ~590 op/B at 1,979 TOP/s); 28->28
// and 28->56, 56->56 at levels 2-3 by operations. mma.sync reaches a
// fraction of the wgmma rate, and at N = 8 (Co = 7) each A fragment feeds
// one product, so the narrow layers are bound by the slab loader and
// shared-memory reads of A, as conv3d_tc's are.
//
// Design (conv3d_tc.cu's data flow at twice the depth per 16-byte row;
// tiles from the host-side plan, ops/kernels/conv3d.py::tcq_plan):
// - GEMM view: M = TY x TX voxels of one z plane (4 warps of MF m16
//   fragments), N = 8*NF output channels of one N tile, K = 27 taps x Ci
//   walked as stages of (dz, channel chunk), each stage `groups` 16-byte
//   k-groups, paired into the k32 of one mma.sync.m16n8k32 (s8 -> s32).
// - The k-group is 16 bytes: 16 channels where Ci > 8 (u = 16: a slot is
//   one voxel, c16s groups of 16 channels, as conv3d_tc). Where Ci <= 8 a
//   16-byte group holds G = 16/u neighbours along x of u = 8 or 4 bytes
//   each (slot s = voxels x0-1+s .. x0-1+s+G-1), so one group covers taps
//   dx..dx+G-1 of one (dz, dy): 6 groups a plane at Ci = 7 (u = 8: dx 0-1
//   and dx 2 + a zero-weight dx 3), 3 at Ci = 2 (u = 4: dx 0-2 + one zero).
//   Padding Ci to 16 instead would take 9 groups a plane at either, and
//   pairing 8-byte taps inside one 16-byte row (conv3d_tc's bf16 trick)
//   breaks ldmatrix's 16-byte alignment at odd x.
// - The fill: the slab loader reads each cell (a voxel's u or 16 bytes)
//   into registers with aligned word loads (ld_bytes8/16: any Ci, any
//   alignment, nothing read past the tensor) and stores the fill bytes
//   (0x80 in zp mode, 0 otherwise) for a cell outside the volume, planes
//   outside included: no tap is skipped, no epilogue correction is
//   needed. Bytes past Ci inside a group hold whatever follows (the next
//   voxel's channels) against zero weights.
// - Weights (packed once per tensor on the host, [group][n][16 bytes])
//   arrive by cp.async; the A fragment of a lane is an ldmatrix row at its
//   voxel's slot plus the group's offset from a tap table; the slot stride
//   is an odd number of 16-byte words.
// - Where the input is one chunk and it fits (the plan's zb > 0: the
//   full-resolution and level-1 layers), a block marches over zb output
//   planes of its tile: the weights of the three dz stay resident, a ring
//   of three slabs holds planes z-1..z+1 and each plane loads one slab, so
//   the loader, which bounds the narrow layers, reads each input plane
//   (zb + 2) / zb times instead of 3. Otherwise a block computes one plane
//   through a two-stage ring of (dz, chunk) stages, as conv3d_tc does.
// - Epilogue: the requant above, the int8 tile staged in shared memory as
//   [voxel][channel] and written out by warps along its rows, so rows of 7
//   or 14 bytes a voxel leave as contiguous runs.
#include "common.cuh"
#include "mma.cuh"

using namespace ctunet;

namespace {

constexpr int TQ_WARPS = 4;
constexpr int TQ_THREADS = 32 * TQ_WARPS;

struct Params {
  const int8_t* x;     // (D, H, W, Ci)
  const int8_t* w;     // (n_tiles, 3, chunks, groups, BN, 16)
  const float* scale;  // (Co,)
  const float* bias;   // (Co,)
  int8_t* out;         // (D, H, W, Co)
  int64_t x_bytes;     // D * H * W * Ci
  int D, H, W, Ci, Co, zp;
  int tx_log2, ty, tiles_x, n_tiles;
  int zb;              // output planes a block marches over; 0: one plane
                       // through the two-stage ring
  int u, g, nx, c16s;  // bytes a voxel takes in a group, voxels per slot,
                       // groups along x per (dz, dy), groups per slot
  int cc, chunks, cs, sx, sy, ncx, groups;
  int slab_bytes, w_bytes;  // per stage
  uint32_t fill;            // four fill bytes
};

// The halo slab of input plane zi and channel chunk `chunk` at (y0 - 1,
// x0 - 1): the fill outside the volume. The walk's cell (r, c, g) is
// voxel x0 - 1 + c of row r, channel group g.
__device__ __forceinline__ void load_slab(const Params& p,
                                          const CellWalk& walk,
                                          unsigned char* slab, int zi, int y0,
                                          int x0, int chunk) {
  const bool zin = zi >= 0 && zi < p.D;
  const int64_t plane = static_cast<int64_t>(zi) * p.H;
  const int n_cells = p.sy * p.ncx * p.c16s;
  int r = walk.r, c = walk.c, g = walk.g;
  for (int i = threadIdx.x; i < n_cells; i += TQ_THREADS) {
    const int yi = y0 - 1 + r, xi = x0 - 1 + c;
    const bool in = zin && yi >= 0 && yi < p.H && xi >= 0 && xi < p.W;
    const int64_t off =
        ((plane + yi) * p.W + xi) * p.Ci + chunk * p.cc + 16 * g;
    unsigned char* row = slab + r * p.sx * p.cs;
    if (p.u == 16) {
      const uint4 q = in ? ld_bytes16(p.x, off, p.x_bytes)
                         : make_uint4(p.fill, p.fill, p.fill, p.fill);
      *reinterpret_cast<uint4*>(row + c * p.cs + 16 * g) = q;
    } else {
      const uint2 q =
          in ? ld_bytes8(p.x, off, p.x_bytes) : make_uint2(p.fill, p.fill);
      // the voxel lies in slots c - j (j < G), at byte u * j of each
      for (int j = 0; j < p.g; ++j) {
        const int s = c - j;
        if (s < 0 || s >= p.sx) continue;
        unsigned char* dst = row + s * p.cs + p.u * j;
        if (p.u == 8) {
          *reinterpret_cast<uint2*>(dst) = q;
        } else {
          *reinterpret_cast<uint32_t*>(dst) = q.x;
        }
      }
    }
    walk.next(r, c, g);
  }
}

// The packed weights of stage (dz, chunk) of N tile nt, as asynchronous
// copies.
__device__ __forceinline__ void load_weights(const Params& p,
                                             unsigned char* wsm, int dz,
                                             int chunk, int nt) {
  const int8_t* wsrc =
      p.w + ((static_cast<int64_t>(nt) * 3 + dz) * p.chunks + chunk) *
                p.w_bytes;
  for (int i = threadIdx.x; i < p.w_bytes / 16; i += TQ_THREADS) {
    cp_async<16>(smem_addr(wsm + i * 16), wsrc + i * 16, true);
  }
}

// One stage's products: the k32 steps over the stage's k-groups, A rows
// from the slab at a_base (the lane's row plus the group's tap offset), B
// from the stage's weights at b_base.
template <int MF, int NF>
__device__ __forceinline__ void mma_stage(int (&acc)[MF][NF][4],
                                          const int* tab,
                                          const int (&row_off)[MF],
                                          uint32_t a_base, uint32_t b_base,
                                          int groups, int lane) {
  constexpr int BN = 8 * NF;
  const int a_half = lane >> 4;        // k-group of the lane's A row
  const int b_half = (lane >> 3) & 1;  // k-group of the lane's B row
#pragma unroll 2
  for (int ks = 0; ks < groups / 2; ++ks) {
    const int toff = tab[2 * ks + a_half];
    uint32_t a[MF][4];
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      ldsm_x4(a[f], a_base + static_cast<uint32_t>(row_off[f] + toff));
    }
    uint32_t b[NF][2];
    load_b<NF>(b, b_base + 16u * static_cast<uint32_t>((2 * ks + b_half) *
                                                       BN),
               lane);
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int n = 0; n < NF; ++n) mma_s8(acc[f][n], a[f], b[n]);
  }
}

// The requant of output plane z's tile, staged compactly ([m][ncol]
// bytes) in `so`, then written out row by row (contiguous runs). Ends with
// every thread's reads of `so` issued; the caller's next barrier orders
// them before `so` is written again.
template <int MF, int NF>
__device__ __forceinline__ void epilogue(const Params& p,
                                         const int (&acc)[MF][NF][4],
                                         int8_t* so, int z, int y0, int x0,
                                         int nt, int lane, int warp) {
  constexpr int BN = 8 * NF;
  const int tx = 1 << p.tx_log2;
  const int n0 = nt * BN;
  const int ncol = min(BN, p.Co - n0);
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    const int col = n * 8 + (lane & 3) * 2;
    const float s0 = col < ncol ? p.scale[n0 + col] : 0.f;
    const float b0 = col < ncol ? p.bias[n0 + col] : 0.f;
    const float s1 = col + 1 < ncol ? p.scale[n0 + col + 1] : 0.f;
    const float b1 = col + 1 < ncol ? p.bias[n0 + col + 1] : 0.f;
#pragma unroll
    for (int f = 0; f < MF; ++f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (warp * MF + f) * 16 + (lane >> 2) + h * 8;
        if (col < ncol) {
          so[m * ncol + col] =
              requant_s8<false>(acc[f][n][2 * h], s0, b0, p.zp);
        }
        if (col + 1 < ncol) {
          so[m * ncol + col + 1] =
              requant_s8<false>(acc[f][n][2 * h + 1], s1, b1, p.zp);
        }
      }
    }
  }
  __syncthreads();
  const int vy = min(p.ty, p.H - y0), vx = min(tx, p.W - x0);
  const int per_row = vx * ncol;
  const int64_t row0 = (static_cast<int64_t>(z) * p.H + y0) * p.W + x0;
  for (int my = warp; my < vy; my += TQ_WARPS) {
    const int8_t* srow = so + my * tx * ncol;  // 8-byte aligned
    if (ncol == p.Co) {  // one N tile: the row is one contiguous run
      int8_t* grow = p.out + (row0 + static_cast<int64_t>(my) * p.W) * p.Co;
      int e0 = 0;
      if ((reinterpret_cast<uintptr_t>(grow) & 3) == 0) {
        const int nw = per_row / 4;
        for (int e = lane; e < nw; e += 32) {
          reinterpret_cast<uint32_t*>(grow)[e] =
              reinterpret_cast<const uint32_t*>(srow)[e];
        }
        e0 = nw * 4;
      }
      for (int e = e0 + lane; e < per_row; e += 32) grow[e] = srow[e];
    } else {
      for (int e = lane; e < per_row; e += 32) {
        const int mx = e / ncol, j = e - mx * ncol;
        p.out[(row0 + static_cast<int64_t>(my) * p.W + mx) * p.Co + n0 + j] =
            srow[e];
      }
    }
  }
}

template <int MF, int NF>
__global__ void __launch_bounds__(TQ_THREADS)
conv3d_tc_q_kernel(const Params p) {
  constexpr int BN = 8 * NF;
  constexpr int TILE = TQ_WARPS * MF * 16 * BN;  // output tile bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int tab_bytes = (p.groups * 4 + 15) / 16 * 16;
  int* tab = reinterpret_cast<int*>(smem);
  unsigned char* buf = smem + tab_bytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x / p.n_tiles;
  const int nt = blockIdx.x - tile * p.n_tiles;
  const int ty_i = tile / p.tiles_x, tx_i = tile - ty_i * p.tiles_x;
  const int tx = 1 << p.tx_log2;
  const int y0 = ty_i * p.ty, x0 = tx_i * tx;

  // slab byte offset of each k-group (dy, x group xg, channel group c16);
  // the pad group (odd count) reads any slab row against zero weights
  const int real_groups = 3 * p.nx * p.c16s;
  for (int g = tid; g < p.groups; g += TQ_THREADS) {
    int off = 0;
    if (g < real_groups) {
      const int t = g / p.c16s, c16 = g - t * p.c16s;
      const int dy = t / p.nx, xg = t - dy * p.nx;
      off = (dy * p.sx + xg * p.g) * p.cs + 16 * c16;
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

  int acc[MF][NF][4];
  const CellWalk walk = cell_walk<TQ_THREADS>(p.ncx, p.c16s);
  if (p.zb) {
    // z-march (one chunk): the three planes' weights stay resident, a
    // ring of three slabs holds planes z-1..z+1, and each step loads one
    // plane, so a block of zb planes reads zb + 2 planes, not 3 * zb
    int8_t* so = reinterpret_cast<int8_t*>(buf);
    unsigned char* wres = buf + TILE;
    unsigned char* ring = wres + 3 * p.w_bytes;
    const int z0 = blockIdx.y * p.zb, z1 = min(z0 + p.zb, p.D);
    for (int dz = 0; dz < 3; ++dz) {
      load_weights(p, wres + dz * p.w_bytes, dz, 0, nt);
    }
    cp_async_commit();
    load_slab(p, walk, ring + ((z0 + 2) % 3) * p.slab_bytes, z0 - 1, y0, x0,
              0);
    load_slab(p, walk, ring + (z0 % 3) * p.slab_bytes, z0, y0, x0, 0);
    for (int z = z0; z < z1; ++z) {
      // plane z+1 into the buffer of plane z-2, free since the barrier
      // inside the last epilogue
      load_slab(p, walk, ring + ((z + 1) % 3) * p.slab_bytes, z + 1, y0, x0,
                0);
      cp_async_wait<0>();
      __syncthreads();  // the slabs, weights and tap table visible to all
#pragma unroll
      for (int f = 0; f < MF; ++f)
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[f][n][j] = 0;
      for (int dz = 0; dz < 3; ++dz) {
        mma_stage<MF, NF>(
            acc, tab, row_off,
            smem_addr(ring + ((z + dz + 2) % 3) * p.slab_bytes),
            smem_addr(wres + dz * p.w_bytes), p.groups, lane);
      }
      epilogue<MF, NF>(p, acc, so, z, y0, x0, nt, lane, warp);
    }
    return;
  }

  // one output plane through a ring of two stages (dz, chunk), every
  // plane read, those outside the volume too (they read the fill)
  const int z = blockIdx.y;
  const int stage_bytes = p.slab_bytes + p.w_bytes;
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f][n][j] = 0;
  const int n_stages = 3 * p.chunks;
  auto fetch = [&](int s) {
    const int dz = s / p.chunks, chunk = s - dz * p.chunks;
    unsigned char* sb = buf + (s & 1) * stage_bytes;
    load_slab(p, walk, sb, z + dz - 1, y0, x0, chunk);
    load_weights(p, sb + p.slab_bytes, dz, chunk, nt);
  };
  fetch(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) fetch(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage s (and the tap table) visible to all
    const unsigned char* sb = buf + (s & 1) * stage_bytes;
    mma_stage<MF, NF>(acc, tab, row_off, smem_addr(sb),
                      smem_addr(sb + p.slab_bytes), p.groups, lane);
    __syncthreads();  // every read of this buffer is done
  }
  cp_async_wait<0>();
  // the requant, staged in the (now free) stage buffers
  epilogue<MF, NF>(p, acc, reinterpret_cast<int8_t*>(buf), z, y0, x0, nt,
                   lane, warp);
}

template <int MF, int NF>
int launch(const Params& p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t stage = static_cast<size_t>(p.slab_bytes + p.w_bytes);
  const size_t tile = static_cast<size_t>(TQ_WARPS * MF * 16) * 8 * NF;
  const size_t tab = static_cast<size_t>(p.groups * 4 + 15) / 16 * 16;
  const size_t smem =
      tab + (p.zb ? tile + 3 * stage
                  : (2 * stage > tile ? 2 * stage : tile));
  if (smem > kMaxSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(conv3d_tc_q_kernel<MF, NF>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch's check
    return static_cast<int>(err);
  }
  const int tiles_y = (p.H + p.ty - 1) / p.ty;
  const dim3 grid(static_cast<unsigned>(tiles_y * p.tiles_x * p.n_tiles),
                  static_cast<unsigned>(p.zb ? (p.D + p.zb - 1) / p.zb
                                             : p.D));
  conv3d_tc_q_kernel<MF, NF>
      <<<grid, TQ_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int MF>
int dispatch_nf(const Params& p, int nf, int device, void* stream) {
  switch (nf) {
    case 1:
      return launch<MF, 1>(p, device, stream);
    case 2:
      return launch<MF, 2>(p, device, stream);
    case 4:
      return launch<MF, 4>(p, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (D,H,W,Ci) int8 (16-byte aligned), w packed by ops/kernels/conv3d.py::
// pack_tcq_weights for the same (mf, nf, tx_log2, u, cc, chunks), scale
// and bias (Co,) f32, out (D,H,W,Co) int8; zp: fill -128 and the zp
// epilogue, else fill 0 and the symmetric one; zb > 0 (one chunk): each
// block marches over zb output planes, 0: one plane per block. Returns
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int ctunet_conv3d_tc_q(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int D, int H, int W, int Ci,
                                  int Co, int zp, int mf, int nf, int tx_log2,
                                  int u, int cc, int chunks, int zb,
                                  int device, void* stream) {
  const bool narrow = u == 4 || u == 8;
  if ((tx_log2 != 3 && tx_log2 != 4) || (mf != 2 && mf != 4) ||
      !(narrow || u == 16) ||
      (narrow ? (Ci > u || cc != u || chunks != 1)
              : (cc <= 0 || cc % 16 != 0 || chunks * cc < Ci)) ||
      zb < 0 || (zb > 0 && chunks != 1) || D <= 0 || H <= 0 || W <= 0 ||
      Ci <= 0 || Co <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.x_bytes = static_cast<int64_t>(D) * H * W * Ci;
  p.D = D;
  p.H = H;
  p.W = W;
  p.Ci = Ci;
  p.Co = Co;
  p.zp = zp ? 1 : 0;
  p.tx_log2 = tx_log2;
  p.ty = TQ_WARPS * 16 * mf >> tx_log2;
  p.tiles_x = (W + (1 << tx_log2) - 1) >> tx_log2;
  p.n_tiles = (Co + 8 * nf - 1) / (8 * nf);
  p.zb = zb;
  p.u = u;
  p.g = 16 / u;
  p.nx = (3 + p.g - 1) / p.g;
  p.c16s = narrow ? 1 : cc / 16;
  p.cc = cc;
  p.chunks = chunks;
  p.cs = 16 * (p.c16s % 2 ? p.c16s : p.c16s + 1);  // odd 16-byte words
  p.sx = (1 << tx_log2) + 2;
  p.sy = p.ty + 2;
  p.ncx = p.sx + p.g - 1;
  p.groups = (3 * p.nx * p.c16s + 1) / 2 * 2;
  p.slab_bytes = p.sy * p.sx * p.cs;
  p.w_bytes = p.groups * 8 * nf * 16;
  p.fill = zp ? 0x80808080u : 0u;
  return mf == 2 ? dispatch_nf<2>(p, nf, device, stream)
                 : dispatch_nf<4>(p, nf, device, stream);
}
