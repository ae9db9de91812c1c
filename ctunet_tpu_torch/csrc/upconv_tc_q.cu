// upconv_tc_q: int8 fused upsample + conv (K3q) on the int8 tensor cores,
// as one implicit GEMM from half-resolution operands.
//
// Replaces, read for what they compute and not for their layout:
//   ctunet_tpu/ops/pallas/upconv.py::upconv_fused_chain_split(scale2=,
//     zp=True) (K3q: body _upconv_kernel_split, epilogue :431-441),
//   ::upconv_fused_chain (K4b: the full-tap form, epilogue :983-993; also
//     its `sparse_gh` skip, which gives the same integers).
// With the composite k4/s2/p1 response r_q (ConvT(k2, s2) o Conv(k3),
// quantized by the caller: engine_q.quant_upconv) split into wa, wb and
// the ones row wone, output voxel v = 2m + p (parity p in {0,1}^3) of
// half-resolution voxel m is
//
//   acc[v,o] = sum over the 8 taps u = m+p-1+t (t in {0,1}^3, R index
//              3-p-2t per dimension) of sum_i x_aug[u,i] * r_q[.,i,o]
//   x_aug[u] = [a[u] | 127 | b[u]] inside the volume; the fill (-128 in
//              zp mode, 0 otherwise) in EVERY lane outside
//   r   = relu(fma(f32(acc), scale[o], bias[4pz+2py+px, o]))
//   zp:  out = rint(min(r, 255)) - 128;  symmetric: out = rint(min(r, 127))
//
// exactly as upconv_q.cu (the CUDA-core kernel this replaces) computes it:
// exact int32 sums, __int2float_rn, one __fmaf_rn, round half to even,
// then the integer -128 (K3q rounds before it subtracts; K1q after).
//
// What bounds it on an H100: 128*(Ca+Cb+1)*Co int8 operations per
// half-resolution voxel against Ca+Cb + 8*Co bytes: (14+14)->7 (out
// 224x304x304) is bound by bytes (65 op/B, the 145 MB output); (28+28)->14
// (130 op/B) by bytes; (56+56)->28 and 56->56 at the small levels by
// operations.
//
// Design (upconv_tc.cu's K3 data flow at twice the depth per 16-byte row;
// tiles from the host-side plan, ops/kernels/upsample_tc.py::uptcq_plan):
// - GEMM view: M = TY x TX half-resolution voxels of one z plane (4 warps
//   of MF m16 fragments), N = 8*NF output channels, for each of the
//   block's NP parities; K = the input lanes as 16-byte groups: operand
//   a's Ca channels and the ones lane (ga = ceil((Ca+1)/16) groups; the
//   ones lane rides a's padding at every path shape), then b's (gb
//   groups), walked in stages of (input plane, chunk of cg groups, cg
//   even); a k32 step takes two groups, which may come from a and b.
// - The ones lane and the fill are written by the slab loader: a cell (a
//   voxel's 16-byte group) inside the volume is read with aligned word
//   loads (ld_bytes16: Ca, Cb of any alignment, nothing read past either
//   tensor) and the ones lane's byte set to 127; a cell outside, planes
//   outside included, holds the fill in every byte. So every tap is summed
//   as it stands, the ones row with the rest: no epilogue term at the
//   faces and no plane skipped. Bytes past a lane inside a group hold what
//   follows in memory, against zero weights.
// - One halo slab per stage, shared by all the block's parities; the A
//   fragment of slab offset (dz, dy, dx) is loaded once (ldmatrix) and fed
//   to every parity that reads it, through the slot table of upconv_tc
//   (the same enumeration as the host's slot_table, which packs the
//   weights: [slot][group][n][16 bytes] per stage).
// - Epilogue: the requant with the parity's bias row, the depth-to-space
//   in shared memory (the 2TY x 2TX full-resolution rows of the block's
//   output planes, int8), and warps write each row as one contiguous run.
#include "common.cuh"
#include "mma.cuh"

using namespace ctunet;

namespace {

constexpr int UQ_WARPS = 4;
constexpr int UQ_THREADS = 32 * UQ_WARPS;
constexpr int NOFF = 9;  // slab offsets (dy, dx) of one plane

struct Params {
  const int8_t* a;     // (D2, H2, W2, Ca)
  const int8_t* b;     // (D2, H2, W2, Cb) or null
  const int8_t* w;     // (n_pg, n_tiles, n_dz, chunks, slots, cg, BN, 16)
  const float* scale;  // (Co,)
  const float* bias;   // (8, Co): row 4*pz + 2*py + px
  int8_t* out;         // (2*D2, 2*H2, 2*W2, Co)
  int64_t a_bytes, b_bytes;
  int D2, H2, W2, Ca, Cb, Co, zp;
  int tx_log2, ty, tiles_x, n_tiles, n_pg, n_dz;
  int cg, chunks, ga, gt, cs, sx, sy;
  int slab_bytes, w_bytes;  // w_bytes: the widest stage's weights
  uint32_t fill;            // four fill bytes
};

// Whether parity p reads slab offset o of plane dz: tap t = delta + 1 - p
// in {0,1}^3 with delta = (dz, o/3 - 1, o%3 - 1).
__device__ __forceinline__ bool reads(int dz, int o, int p) {
  const int tz = dz + 1 - (p >> 2);
  const int ty = o / 3 - ((p >> 1) & 1);
  const int tx = o % 3 - (p & 1);
  return static_cast<unsigned>(tz) <= 1u && static_cast<unsigned>(ty) <= 1u &&
         static_cast<unsigned>(tx) <= 1u;
}

// Slots of plane dz for the parities p0..p0+NP-1: 4 (ty, tx) taps for
// each parity whose tz is a tap.
template <int NP>
__device__ __forceinline__ int n_slots(int dz, int p0) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    n += static_cast<unsigned>(dz + 1 - ((p0 + j) >> 2)) <= 1u ? 4 : 0;
  }
  return n;
}

// byte k (0..15) of q set to v
__device__ __forceinline__ uint4 set_byte(uint4 q, int k, uint32_t v) {
  const uint32_t sh = (k & 3) * 8, m = 0xFFu << sh, bits = v << sh;
  const int wi = k >> 2;
  q.x = wi == 0 ? (q.x & ~m) | bits : q.x;
  q.y = wi == 1 ? (q.y & ~m) | bits : q.y;
  q.z = wi == 2 ? (q.z & ~m) | bits : q.z;
  q.w = wi == 3 ? (q.w & ~m) | bits : q.w;
  return q;
}

// Stage (plane zi, chunk): the slab at (y0 - 1, x0 - 1) of the chunk's
// groups (operand a with the ones lane, then b; the fill outside the
// volume) and n_w weight bytes, the weights as asynchronous copies.
__device__ __forceinline__ void load_stage(const Params& p,
                                           const CellWalk& walk,
                                           unsigned char* slab,
                                           unsigned char* wsm, int zi, int y0,
                                           int x0, int chunk,
                                           const int8_t* wsrc, int n_w) {
  const bool zin = zi >= 0 && zi < p.D2;
  const int64_t plane = static_cast<int64_t>(zi) * p.H2;
  const int n_cells = p.sy * p.sx * p.cg;
  int r = walk.r, c = walk.c, g = walk.g;
  for (int i = threadIdx.x; i < n_cells; i += UQ_THREADS) {
    const int yi = y0 - 1 + r, xi = x0 - 1 + c;
    const int gi = chunk * p.cg + g;
    const bool in = zin && yi >= 0 && yi < p.H2 && xi >= 0 && xi < p.W2;
    uint4 q = make_uint4(p.fill, p.fill, p.fill, p.fill);
    if (in && gi < p.gt) {
      const int64_t vox = (plane + yi) * p.W2 + xi;
      if (gi < p.ga) {
        q = ld_bytes16(p.a, vox * p.Ca + 16 * gi, p.a_bytes);
        const int k = p.Ca - 16 * gi;
        if (k < 16) q = set_byte(q, k, 127u);  // the ones lane inside
      } else {
        q = ld_bytes16(p.b, vox * p.Cb + 16 * (gi - p.ga), p.b_bytes);
      }
    }
    *reinterpret_cast<uint4*>(slab + (r * p.sx + c) * p.cs + 16 * g) = q;
    walk.next(r, c, g);
  }
  for (int i = threadIdx.x; i < n_w / 16; i += UQ_THREADS) {
    cp_async<16>(smem_addr(wsm + i * 16), wsrc + i * 16, true);
  }
}

template <int NP, int MF, int NF>
__global__ void __launch_bounds__(UQ_THREADS)
upconv_tc_q_kernel(const Params p) {
  constexpr int BN = 8 * NF;
  constexpr int TAB = 3 * NOFF * (NP + 1);  // slots, then counts per row
  constexpr int TAB_BYTES = (TAB * 4 + 15) / 16 * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  int* stab = reinterpret_cast<int*>(smem);
  int* scount = stab + 3 * NOFF * NP;
  unsigned char* buf = smem + TAB_BYTES;
  const int stage_bytes = p.slab_bytes + p.w_bytes;

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
  const int dz_lo = pz_lo - 1;

  // slot table: row (plane dzi, offset o) gives each parity's slot in the
  // stage's weights, numbered over (o, parity) in order, or -1
  for (int row = tid; row < p.n_dz * NOFF; row += UQ_THREADS) {
    const int dzi = row / NOFF, o = row - dzi * NOFF, dz = dz_lo + dzi;
    int slot = 0;
    for (int o2 = 0; o2 < o; ++o2) {
      for (int j = 0; j < NP; ++j) slot += reads(dz, o2, p0 + j);
    }
    int n = 0;
    for (int j = 0; j < NP; ++j) {
      const bool r = reads(dz, o, p0 + j);
      stab[row * NP + j] = r ? slot + n : -1;
      n += r;
    }
    scount[row] = n;
  }

  // each lane's A row: voxel (lane & 15) of the warp's m16 fragment f
  int row_off[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    const int m = (warp * MF + f) * 16 + (lane & 15);
    const int my = m >> p.tx_log2, mx = m & (tx - 1);
    row_off[f] = (my * p.sx + mx) * p.cs;
  }

  int acc[NP][MF][NF][4];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][f][n][e] = 0;

  // every plane, those outside the volume too (they read the fill)
  const int n_stages = p.n_dz * p.chunks;
  const CellWalk walk = cell_walk<UQ_THREADS>(p.sx, p.cg);
  const int64_t w_block =
      (static_cast<int64_t>(pg) * p.n_tiles + nt) * p.n_dz;
  auto fetch = [&](int s) {
    const int dzi = s / p.chunks, chunk = s - dzi * p.chunks;
    const int dz = dz_lo + dzi;
    unsigned char* sb = buf + (s & 1) * stage_bytes;
    const int8_t* wsrc =
        p.w + ((w_block + dzi) * p.chunks + chunk) * p.w_bytes;
    load_stage(p, walk, sb, sb + p.slab_bytes, z + dz, y0, x0, chunk, wsrc,
               n_slots<NP>(dz, p0) * p.cg * BN * 16);
  };

  const int a_half = lane >> 4;        // k-group of the lane's A row
  const int b_half = (lane >> 3) & 1;  // k-group of the lane's B row
  fetch(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) fetch(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage s (and the slot table) visible to all
    const unsigned char* sb = buf + (s & 1) * stage_bytes;
    const uint32_t a_base = smem_addr(sb);
    const uint32_t b_base = smem_addr(sb + p.slab_bytes);
    const int dzi = s / p.chunks;
    for (int o = 0; o < NOFF; ++o) {
      const int row = dzi * NOFF + o;
      if (scount[row] == 0) continue;
      const int off = ((o / 3) * p.sx + o % 3) * p.cs;
      int sl[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) sl[j] = stab[row * NP + j];
      for (int ks = 0; ks < p.cg / 2; ++ks) {
        uint32_t a[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          ldsm_x4(a[f], a_base + static_cast<uint32_t>(
                                     row_off[f] + off +
                                     16 * (2 * ks + a_half)));
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (sl[j] < 0) continue;
          uint32_t b[NF][2];
          load_b<NF>(b, b_base + 16u * static_cast<uint32_t>(
                                           (sl[j] * p.cg + 2 * ks + b_half) *
                                           BN),
                     lane);
#pragma unroll
          for (int f = 0; f < MF; ++f)
#pragma unroll
            for (int n = 0; n < NF; ++n) mma_s8(acc[j][f][n], a[f], b[n]);
        }
      }
    }
    __syncthreads();  // every read of this buffer is done
  }
  cp_async_wait<0>();

  // epilogue: requant with the parity's bias row, int8, staged as full-
  // resolution rows [zl][my][yl][2*mx + px][ncol] in the free stage buffers
  const int n0 = nt * BN;
  const int ncol = min(BN, p.Co - n0);
  constexpr int NY = NP >= 4 ? 2 : 1;
  const int row_len = 2 * tx * ncol;
  int8_t* so = reinterpret_cast<int8_t*>(buf);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int par = p0 + j;
    const int pz = par >> 2, py = (par >> 1) & 1, px = par & 1;
    const int zl = NP == 8 ? pz : 0, yl = NP >= 4 ? py : 0;
    const float* brow = p.bias + static_cast<int64_t>(par) * p.Co + n0;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      const float s0 = col < ncol ? p.scale[n0 + col] : 0.f;
      const float b0 = col < ncol ? brow[col] : 0.f;
      const float s1 = col + 1 < ncol ? p.scale[n0 + col + 1] : 0.f;
      const float b1 = col + 1 < ncol ? brow[col + 1] : 0.f;
#pragma unroll
      for (int f = 0; f < MF; ++f) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = (warp * MF + f) * 16 + (lane >> 2) + hh * 8;
          const int my = m >> p.tx_log2, mx = m & (tx - 1);
          const int idx =
              (((zl * p.ty + my) * NY + yl) * 2 * tx + 2 * mx + px) * ncol +
              col;
          if (col < ncol) {
            so[idx] = requant_s8<true>(acc[j][f][n][2 * hh], s0, b0, p.zp);
          }
          if (col + 1 < ncol) {
            so[idx + 1] =
                requant_s8<true>(acc[j][f][n][2 * hh + 1], s1, b1, p.zp);
          }
        }
      }
    }
  }
  __syncthreads();
  const int vy = min(p.ty, p.H2 - y0), vx = min(tx, p.W2 - x0);
  const int per_row = 2 * vx * ncol;
  const int n_rows = (NP == 8 ? 2 : 1) * p.ty * NY;
  const int ho = 2 * p.H2, wo = 2 * p.W2;
  for (int r = warp; r < n_rows; r += UQ_WARPS) {
    const int yl = NY == 2 ? (r & 1) : 0;
    const int rz = NY == 2 ? r >> 1 : r;
    const int zl = rz / p.ty, my = rz - zl * p.ty;
    if (my >= vy) continue;
    const int zo = 2 * z + (NP == 8 ? zl : pz_lo);
    const int yo = 2 * (y0 + my) + (NP >= 4 ? yl : (p0 >> 1) & 1);
    const int64_t vox = (static_cast<int64_t>(zo) * ho + yo) * wo + 2 * x0;
    const int8_t* srow = so + r * row_len;  // 16-byte aligned: 2*tx >= 16
    if (ncol == p.Co) {  // one N tile: the row is one contiguous run
      int8_t* grow = p.out + vox * p.Co;
      int e0 = 0;
      if ((reinterpret_cast<uintptr_t>(grow) & 15) == 0) {
        const int nv = per_row / 16;
        for (int e = lane; e < nv; e += 32) {
          reinterpret_cast<uint4*>(grow)[e] =
              reinterpret_cast<const uint4*>(srow)[e];
        }
        e0 = nv * 16;
      } else if ((reinterpret_cast<uintptr_t>(grow) & 3) == 0) {
        const int nv = per_row / 4;
        for (int e = lane; e < nv; e += 32) {
          reinterpret_cast<uint32_t*>(grow)[e] =
              reinterpret_cast<const uint32_t*>(srow)[e];
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

template <int NP, int MF, int NF>
int launch(const Params& p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t tab = (3 * NOFF * (NP + 1) * 4 + 15) / 16 * 16;
  const size_t stage = static_cast<size_t>(p.slab_bytes + p.w_bytes);
  const size_t tile = static_cast<size_t>(NP) * UQ_WARPS * MF * 16 * 8 * NF;
  const size_t smem = tab + (2 * stage > tile ? 2 * stage : tile);
  if (smem > kMaxSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(upconv_tc_q_kernel<NP, MF, NF>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch's check
    return static_cast<int>(err);
  }
  const int tiles_y = (p.H2 + p.ty - 1) / p.ty;
  const dim3 grid(
      static_cast<unsigned>(tiles_y * p.tiles_x * p.n_pg * p.n_tiles),
      static_cast<unsigned>(p.D2));
  upconv_tc_q_kernel<NP, MF, NF>
      <<<grid, UQ_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NP, int MF>
int dispatch_nf(const Params& p, int nf, int device, void* stream) {
  if constexpr (NP * MF * 4 <= 16) {
    if (nf == 4) return launch<NP, MF, 4>(p, device, stream);
  }
  if constexpr (NP * MF * 2 <= 16) {
    if (nf == 2) return launch<NP, MF, 2>(p, device, stream);
  }
  if (nf == 1) return launch<NP, MF, 1>(p, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NP>
int dispatch_mf(const Params& p, int mf, int nf, int device, void* stream) {
  if constexpr (NP * 2 <= 16) {
    if (mf == 2) return dispatch_nf<NP, 2>(p, nf, device, stream);
  }
  if (mf == 1) return dispatch_nf<NP, 1>(p, nf, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a (D2,H2,W2,Ca) and b (D2,H2,W2,Cb) int8, 16-byte aligned (b null and
// Cb 0 for one operand), w packed by ops/kernels/upsample_tc.py::
// pack_weights_q for the same (np, nf, cg, chunks), scale (Co,) and bias
// (8, Co) f32, out (2*D2, 2*H2, 2*W2, Co) int8; zp: fill -128 and the zp
// epilogue, else fill 0 and the symmetric one. Returns
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int ctunet_upconv_tc_q(const void* a, const void* b, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int D2, int H2, int W2, int Ca,
                                  int Cb, int Co, int zp, int np, int mf,
                                  int nf, int tx_log2, int cg, int chunks,
                                  int device, void* stream) {
  const int ga = (Ca + 1 + 15) / 16, gb = (Cb + 15) / 16;
  if ((tx_log2 != 3 && tx_log2 != 4) || cg <= 0 || cg % 2 != 0 ||
      chunks * cg < ga + gb || (chunks - 1) * cg >= ga + gb ||
      (Cb > 0) != (b != nullptr) || np * mf * nf > 16 || D2 <= 0 ||
      H2 <= 0 || W2 <= 0 || Ca <= 0 || Cb < 0 || Co <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<int8_t*>(out);
  p.a_bytes = static_cast<int64_t>(D2) * H2 * W2 * Ca;
  p.b_bytes = static_cast<int64_t>(D2) * H2 * W2 * Cb;
  p.D2 = D2;
  p.H2 = H2;
  p.W2 = W2;
  p.Ca = Ca;
  p.Cb = Cb;
  p.Co = Co;
  p.zp = zp ? 1 : 0;
  p.tx_log2 = tx_log2;
  p.ty = UQ_WARPS * 16 * mf >> tx_log2;
  p.tiles_x = (W2 + (1 << tx_log2) - 1) >> tx_log2;
  p.n_tiles = (Co + 8 * nf - 1) / (8 * nf);
  p.n_pg = 8 / np;
  p.n_dz = np == 8 ? 3 : 2;
  p.cg = cg;
  p.chunks = chunks;
  p.ga = ga;
  p.gt = ga + gb;
  p.cs = 16 * (cg + 1);  // an odd number of 16-byte words a voxel
  p.sx = (1 << tx_log2) + 2;
  p.sy = p.ty + 2;
  p.slab_bytes = p.sy * p.sx * p.cs;
  p.w_bytes = 4 * np * cg * 8 * nf * 16;
  p.fill = zp ? 0x80808080u : 0u;
  switch (np) {
    case 2:
      return dispatch_mf<2>(p, mf, nf, device, stream);
    case 4:
      return dispatch_mf<4>(p, mf, nf, device, stream);
    case 8:
      return dispatch_mf<8>(p, mf, nf, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
