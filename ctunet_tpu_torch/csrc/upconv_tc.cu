// upconv_tc: the stride-2 upsampling kernels on the tensor cores, as one
// implicit GEMM from half-resolution operands.
//
// Replaces, read for what they compute and not for their layout:
//   ctunet_tpu/ops/pallas/upconv.py::upconv_fused_chain_split (bf16 mode;
//     UNetSP's decoder: ConvT(k2, s2) + bias fused with the next Conv3D(k3)
//     + folded BN + ReLU, K3),
//   ctunet_tpu/ops/pallas/convt.py::conv_transpose_k2s2 (K7a) and
//     ::conv_transpose_k2s2_dual (K7b; the legacy family's ConvT(k2, s2) +
//     bias of one operand, or of the never-built concat of two).
// On dense channels-last volumes, output voxel 2m+p (parity p in {0,1}^3)
// of the half-resolution voxel m is
//
//   out[2m+p, o] = bf16(act(bias[o] + sum_{t in T} (
//                     sum_i A[m+off(p,t), i] * Wa[p,t,i,o]
//                   + sum_j B[m+off(p,t), j] * Wb[p,t,j,o]
//                   + [K3] wone[p,t,o] if m+off(p,t) lies inside)))
//
// K7: T = {0}, off = 0, Wa[p,0] = the ConvT weights of parity p, no act.
// K3: T = {0,1}^3, off(p,t) = p-1+t, Wa[p,t] = R[3-p-2t], the composite
// k4/s2/p1 response of ConvT o Conv (ops/kernels/upconv.py), act = ReLU;
// the ConvT bias rides a ones channel that is 1 inside the half-resolution
// volume and 0 outside, so its term wone depends on position near every
// face. Operands outside the volume are zero. f32 accumulation, one
// rounding to bf16.
//
// What bounds it on an H100: the output is 8 times the input's voxels.
// K7 does 16*Ct*Co flops per input voxel against 2*Ct + 16*Co bytes
// (Ct = Ca + Cb): 25 flop/B at (14+14)->28, 100 at (56+56)->112, 114 at
// 128->128, all under the bf16 ridge (~295 flop/B): bound by bytes, above
// all the output (1.16 GB at (14+14)->28 over 224x304x304). K3 does
// 128*Ct*Co flops per half-resolution voxel against 2*Ct + 16*Co bytes:
// 149 flop/B at (14+14)->7 (bytes: 0.29 GB), 299 at (28+28)->14 (at the
// ridge), 597 at (56+56)->28 and 398 at 56->56 (operations, on small
// volumes).
//
// Design (tiles from the host-side plan, ops/kernels/upsample_tc.py):
// - GEMM view: M = a tile of TY x TX half-resolution voxels of one z plane
//   (64*MF: 4 warps of MF m16 fragments); N = BN = 8*NF output channels of
//   one N tile, for each of the block's NP parities (2, 4 or 8; the grid
//   walks parity groups and N tiles); K = input channels in stages of
//   (input plane, channel chunk of Cc, a multiple of 16).
// - One halo slab per stage, shared by all the block's parities: the
//   (TY+2) x (TX+2) x Cc slab of plane z+dz (K7: TY x TX of plane z, no
//   halo), filled by cp.async with zero-fill (src-size 0) outside the
//   volume and past the operand's channels. The A fragment of slab offset
//   (dz, dy, dx) is loaded once (ldmatrix) and fed to every parity that
//   reads that offset: in K3 all 8 parities read offset 0, 64/27 ~ 2.4 on
//   average; in K7 every parity reads the one offset.
// - Two operands are two ranges of K through two pointers: the chunks of A
//   then the chunks of B. K7a is Cb = 0. The concat is never built.
// - Weights are packed once on the host per (parity group, N tile, plane,
//   chunk) as the stage's slots [(offset, parity) pairs][k-group][BN][8];
//   a per-block slot table (the same enumeration as the host's) maps each
//   (plane, offset, parity) to its slot or -1.
// - Epilogue: bias, the K3 ones-channel term (the sum of wone over the
//   in-bounds taps: a precomputed full sum inside the volume, tap by tap
//   at the faces, exact at every face, edge and corner), ReLU flag, one
//   rounding; the depth-to-space happens in shared memory, which stages
//   the 2TY x 2TX full-resolution rows of the block's output planes, and
//   warps write each row as one contiguous run (16-byte stores where it is
//   aligned), so rows of 7 or 14 channels (14 or 28 bytes a voxel) leave
//   whole.
#include "common.cuh"
#include "mma.cuh"

using namespace ctunet;

namespace {

constexpr int UT_WARPS = 4;
constexpr int UT_THREADS = 32 * UT_WARPS;

struct Params {
  const __nv_bfloat16* a;  // (D2, H2, W2, Ca)
  const __nv_bfloat16* b;  // (D2, H2, W2, Cb) or null
  const __nv_bfloat16* w;  // (n_pg, n_tiles, n_dz, chunks, slots, Cc/8, BN, 8)
  const float* wone;       // (8, 9, Co): per parity, per tap, then the sum
  const float* bias;       // (Co,)
  __nv_bfloat16* out;      // (2*D2, 2*H2, 2*W2, Co)
  int D2, H2, W2, Ca, Cb, Co, relu;
  int tx_log2, ty, tiles_x, n_tiles, n_pg, n_dz;
  int cc, chunks_a, chunks, cs, sx, sy, unit_a, unit_b;
  int slab_elems, w_elems;  // w_elems: bf16 elements of the widest
                            // stage's weights (slots * Cc * BN)
};

// Whether parity p reads slab offset o of plane dz (K3: tap t = delta + 1
// - p in {0,1}^3 with delta = (dz, o/3 - 1, o%3 - 1)); K7 reads its one
// offset in every parity.
template <int H>
__device__ __forceinline__ bool reads(int dz, int o, int p) {
  if constexpr (H == 0) {
    return true;
  } else {
    const int tz = dz + 1 - (p >> 2);
    const int ty = o / 3 - ((p >> 1) & 1);
    const int tx = o % 3 - (p & 1);
    return static_cast<unsigned>(tz) <= 1u &&
           static_cast<unsigned>(ty) <= 1u && static_cast<unsigned>(tx) <= 1u;
  }
}

// Slots of plane dz for the parities p0..p0+NP-1: 4 (ty, tx) taps for each
// parity whose tz is a tap (K3), one for each parity (K7).
template <int H, int NP>
__device__ __forceinline__ int n_slots(int dz, int p0) {
  if constexpr (H == 0) {
    return NP;
  } else {
    int n = 0;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      n += static_cast<unsigned>(dz + 1 - ((p0 + j) >> 2)) <= 1u ? 4 : 0;
    }
    return n;
  }
}

// A thread's walk over the slab's 16-byte slots (voxel (r, c), channel
// group g of 8): slot tid first, then every UT_THREADS-th, stepped without
// divisions.
struct SlotWalk {
  int r, c, g;
  int dr, dc, dg;
};

__device__ __forceinline__ SlotWalk slot_walk(const Params& p) {
  const int c8s = p.cc / 8;
  const int v = threadIdx.x / c8s, dv = UT_THREADS / c8s;
  return {v / p.sx, v % p.sx, static_cast<int>(threadIdx.x) % c8s,
          dv / p.sx, dv % p.sx, UT_THREADS % c8s};
}

// Stage (plane zi, channel chunk of operand src with C channels from ch0):
// the slab at (y0 - H, x0 - H) and n_w weight elements, as asynchronous
// copies (odd C is read element by element into registers and stored 16
// bytes at a time, published by the same barrier).
template <int H>
__device__ __forceinline__ void load_stage(
    const Params& p, const SlotWalk& walk, __nv_bfloat16* slab,
    __nv_bfloat16* wsm, const __nv_bfloat16* src0, int C, int ch0, int unit,
    int zi, int y0, int x0, const __nv_bfloat16* wsrc, int n_w) {
  const int c8s = p.cc / 8;
  const int n_slab = p.sy * p.sx * c8s;
  const int64_t plane = static_cast<int64_t>(zi) * p.H2;
  int r = walk.r, c = walk.c, g = walk.g;
  for (int i = threadIdx.x; i < n_slab; i += UT_THREADS) {
    const int yi = y0 - H + r, xi = x0 - H + c;
    const int ch = ch0 + g * 8;
    const bool in = yi >= 0 && yi < p.H2 && xi >= 0 && xi < p.W2;
    const __nv_bfloat16* src =
        in ? src0 + ((plane + yi) * p.W2 + xi) * C + ch : src0;
    __nv_bfloat16* dst = slab + (r * p.sx + c) * p.cs + g * 8;
    const uint32_t d = smem_addr(dst);
    switch (unit) {
      case 8:
        cp_async<16>(d, src, in && ch < C);
        break;
      case 4:
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = in && ch + 4 * j < C;
          cp_async<8>(d + 8 * j, ok ? src + 4 * j : src0, ok);
        }
        break;
      case 2:
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = in && ch + 2 * j < C;
          cp_async<4>(d + 4 * j, ok ? src + 2 * j : src0, ok);
        }
        break;
      default: {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        uint4 q;
        q.x = ld_pair(s16, in && ch < C, in && ch + 1 < C);
        q.y = ld_pair(s16 + 2, in && ch + 2 < C, in && ch + 3 < C);
        q.z = ld_pair(s16 + 4, in && ch + 4 < C, in && ch + 5 < C);
        q.w = ld_pair(s16 + 6, in && ch + 6 < C, in && ch + 7 < C);
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
  for (int i = threadIdx.x; i < n_w / 8; i += UT_THREADS) {
    cp_async<16>(smem_addr(wsm + i * 8), wsrc + i * 8, true);
  }
}

template <int H, int NP, int MF, int NF>
__global__ void __launch_bounds__(UT_THREADS)
upconv_tc_kernel(const Params p) {
  constexpr int BN = 8 * NF;
  constexpr int NOFF = (2 * H + 1) * (2 * H + 1);
  constexpr int TAB = 3 * NOFF * (NP + 1);  // slots, then counts per row
  constexpr int TAB_BYTES = (TAB * 4 + 15) / 16 * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  int* stab = reinterpret_cast<int*>(smem);
  int* scount = stab + 3 * NOFF * NP;
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem + TAB_BYTES);
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

  // slot table: row (plane dzi, offset o) gives each parity's slot in the
  // stage's weights, numbered over (o, parity) in order, or -1
  for (int row = tid; row < p.n_dz * NOFF; row += UT_THREADS) {
    const int dzi = row / NOFF, o = row - dzi * NOFF, dz = dz_lo + dzi;
    int slot = 0;
    for (int o2 = 0; o2 < o; ++o2) {
      for (int j = 0; j < NP; ++j) slot += reads<H>(dz, o2, p0 + j);
    }
    int n = 0;
    for (int j = 0; j < NP; ++j) {
      const bool r = reads<H>(dz, o, p0 + j);
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
    const int dz = dz_lo + dzi;
    __nv_bfloat16* sb = buf + (s & 1) * stage_elems;
    const bool in_a = chunk < p.chunks_a;
    const __nv_bfloat16* wsrc =
        p.w + ((w_block + dzi) * p.chunks + chunk) * p.w_elems;
    load_stage<H>(p, walk, sb, sb + p.slab_elems, in_a ? p.a : p.b,
                  in_a ? p.Ca : p.Cb,
                  (in_a ? chunk : chunk - p.chunks_a) * p.cc,
                  in_a ? p.unit_a : p.unit_b, z + dz, y0, x0, wsrc,
                  n_slots<H, NP>(dz, p0) * p.cc * BN);
  };

  const int a_half = lane >> 4;        // k-group of the lane's A row
  const int b_half = (lane >> 3) & 1;  // k-group of the lane's B row
  const int c8s = p.cc / 8;
  if (n_stages > 0) fetch(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) fetch(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage s (and the slot table) visible to all
    const __nv_bfloat16* sb = buf + (s & 1) * stage_elems;
    const uint32_t a_base = smem_addr(sb);
    const uint32_t b_base = smem_addr(sb + p.slab_elems);
    const int dzi = dzi_lo + s / p.chunks;
    for (int o = 0; o < NOFF; ++o) {
      const int row = dzi * NOFF + o;
      if (scount[row] == 0) continue;
      const int off = H ? ((o / 3) * p.sx + o % 3) * p.cs : 0;
      int sl[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) sl[j] = stab[row * NP + j];
      for (int ks = 0; ks < c8s / 2; ++ks) {
        uint32_t a[MF][4];
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          ldsm_x4(a[f], a_base + 2u * static_cast<uint32_t>(
                                          row_off[f] + off +
                                          (2 * ks + a_half) * 8));
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (sl[j] < 0) continue;
          uint32_t b[NF][2];
          load_b<NF>(b, b_base + 16u * static_cast<uint32_t>(
                                           (sl[j] * c8s + 2 * ks + b_half) *
                                           BN),
                     lane);
#pragma unroll
          for (int f = 0; f < MF; ++f)
#pragma unroll
            for (int n = 0; n < NF; ++n) mma_bf16(acc[j][f][n], a[f], b[n]);
        }
      }
    }
    __syncthreads();  // every read of this buffer is done
  }
  cp_async_wait<0>();

  // epilogue: bias, ones-channel term, ReLU, bf16, staged as full-
  // resolution rows [zl][my][yl][2*mx + px][ncol] in the free stage buffers
  const int n0 = nt * BN;
  const int ncol = min(BN, p.Co - n0);
  constexpr int NY = NP >= 4 ? 2 : 1;
  const int row_len = 2 * tx * ncol;
  __nv_bfloat16* so = buf;
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
          if (col < ncol) so[idx] = __float2bfloat16(v0);
          if (col + 1 < ncol) so[idx + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
  __syncthreads();
  const int vy = min(p.ty, p.H2 - y0), vx = min(tx, p.W2 - x0);
  const int per_row = 2 * vx * ncol;
  const int n_rows = (NP == 8 ? 2 : 1) * p.ty * NY;
  const int ho = 2 * p.H2, wo = 2 * p.W2;
  for (int r = warp; r < n_rows; r += UT_WARPS) {
    const int yl = NY == 2 ? (r & 1) : 0;
    const int rz = NY == 2 ? r >> 1 : r;
    const int zl = rz / p.ty, my = rz - zl * p.ty;
    if (my >= vy) continue;
    const int zo = 2 * z + (NP == 8 ? zl : pz_lo);
    const int yo = 2 * (y0 + my) + (NP >= 4 ? yl : (p0 >> 1) & 1);
    const int64_t vox = (static_cast<int64_t>(zo) * ho + yo) * wo + 2 * x0;
    const __nv_bfloat16* srow = so + r * row_len;
    if (ncol == p.Co) {  // one N tile: the row is one contiguous run
      __nv_bfloat16* grow = p.out + vox * p.Co;
      int e0 = 0;
      if ((reinterpret_cast<uintptr_t>(grow) & 15) == 0) {
        const int nv = per_row / 8;  // srow is 16-byte aligned: 2*tx >= 16
        for (int e = lane; e < nv; e += 32) {
          reinterpret_cast<uint4*>(grow)[e] =
              reinterpret_cast<const uint4*>(srow)[e];
        }
        e0 = nv * 8;
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
  constexpr int NOFF = (2 * H + 1) * (2 * H + 1);
  const size_t tab = (3 * NOFF * (NP + 1) * 4 + 15) / 16 * 16;
  const size_t stage = 2 * static_cast<size_t>(p.slab_elems + p.w_elems);
  const size_t tile = static_cast<size_t>(NP) * UT_WARPS * MF * 16 * 8 * NF *
                      sizeof(__nv_bfloat16);
  const size_t smem = tab + (2 * stage > tile ? 2 * stage : tile);
  if (smem > kMaxSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(upconv_tc_kernel<H, NP, MF, NF>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch's check
    return static_cast<int>(err);
  }
  const int tiles_y = (p.H2 + p.ty - 1) / p.ty;
  const dim3 grid(
      static_cast<unsigned>(tiles_y * p.tiles_x * p.n_pg * p.n_tiles),
      static_cast<unsigned>(p.D2));
  upconv_tc_kernel<H, NP, MF, NF>
      <<<grid, UT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int NP, int MF>
int dispatch_nf(const Params& p, int nf, int device, void* stream) {
  if constexpr (NP * MF * 4 <= 16) {
    if (nf == 4) return launch<H, NP, MF, 4>(p, device, stream);
  }
  if constexpr (NP * MF * 2 <= 16) {
    if (nf == 2) return launch<H, NP, MF, 2>(p, device, stream);
  }
  if (nf == 1) return launch<H, NP, MF, 1>(p, device, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int H, int NP>
int dispatch_mf(const Params& p, int mf, int nf, int device, void* stream) {
  if constexpr (NP * 2 <= 16) {
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
      return dispatch_mf<H, 8>(p, mf, nf, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int copy_unit(int c) {
  return c % 8 == 0 ? 8 : c % 4 == 0 ? 4 : c % 2 == 0 ? 2 : 1;
}

}  // namespace

// a (D2,H2,W2,Ca) and b (D2,H2,W2,Cb) bf16 (b null and Cb 0 for one
// operand), w packed by ops/kernels/upsample_tc.py::pack_weights for the same
// (k3, np, nf, cc, chunks_a, chunks_b), wone (8, 9, Co) f32 (K3 only, else
// null), bias (Co,) f32, out (2*D2, 2*H2, 2*W2, Co) bf16. k3 = 1: the K3
// function (8 taps a parity, halo, ones term); 0: K7. Returns
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int ctunet_upconv_tc(const void* a, const void* b, const void* w,
                                const void* wone, const void* bias, void* out,
                                int D2, int H2, int W2, int Ca, int Cb, int Co,
                                int k3, int relu, int np, int mf, int nf,
                                int tx_log2, int cc, int chunks_a,
                                int chunks_b, int device, void* stream) {
  if ((tx_log2 != 3 && tx_log2 != 4) || (cc != 16 && cc != 32 && cc != 64) ||
      chunks_a * cc < Ca || chunks_b * cc < Cb || (Cb > 0) != (b != nullptr) ||
      (Cb == 0) != (chunks_b == 0) || (k3 != 0) != (wone != nullptr) ||
      np * mf * nf > 16 || D2 <= 0 || H2 <= 0 || W2 <= 0 || Ca <= 0 ||
      Co <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int h = k3 ? 1 : 0;
  Params p;
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.wone = static_cast<const float*>(wone);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.D2 = D2;
  p.H2 = H2;
  p.W2 = W2;
  p.Ca = Ca;
  p.Cb = Cb;
  p.Co = Co;
  p.relu = relu;
  p.tx_log2 = tx_log2;
  p.ty = UT_WARPS * 16 * mf >> tx_log2;
  p.tiles_x = (W2 + (1 << tx_log2) - 1) >> tx_log2;
  p.n_tiles = (Co + 8 * nf - 1) / (8 * nf);
  p.n_pg = 8 / np;
  p.n_dz = k3 ? (np == 8 ? 3 : 2) : 1;
  p.cc = cc;
  p.chunks_a = chunks_a;
  p.chunks = chunks_a + chunks_b;
  p.cs = cc + 8;  // an odd number of 16-byte words a voxel
  p.sx = (1 << tx_log2) + 2 * h;
  p.sy = p.ty + 2 * h;
  p.unit_a = copy_unit(Ca);
  p.unit_b = Cb > 0 ? copy_unit(Cb) : 8;
  const int slots = k3 ? 4 * np : np;  // the widest stage's
  p.slab_elems = p.sy * p.sx * p.cs;
  p.w_elems = slots * cc * 8 * nf;
  return k3 ? dispatch_np<1>(p, np, mf, nf, device, stream)
            : dispatch_np<0>(p, np, mf, nf, device, stream);
}
