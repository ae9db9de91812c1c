// K2 and K2q for Hopper: the 2x2x2 stride-2 max pool of a channels-last
// volume in bf16, f32 (K2) and int8 (K2q), as one row-streaming kernel.
//
// Replaces ctunet_tpu/ops/pallas/conv3d.py::maxpool2_chain (pallas_call at
// :1906, kernel body _pool_kernel) in its three modes: bf16 and f32 (the
// JAX engine pools in its compute dtype) and int8 (fill=-128, the int8
// engine's zero point; the dense output has no halo, so the fill has no
// counterpart here). csrc/maxpool.cu, one thread per output element, is the
// kernel it replaced; it stays as the *_direct entries for timing.
//
//   out[z,y,x,c] = max_{a,b,d in {0,1}} in[2z+a, 2y+b, 2x+d, c]
//
// Odd extents floor; a NaN in a bf16 or f32 window gives NaN, as
// F.max_pool3d does. A max rounds nothing, so the result equals the plain
// version by value (a tie of -0 and +0 may keep either sign).
//
// What bounds it on an H100: bytes. It reads the input once and writes an
// eighth of it back: 290 + 36 MB at the 224x304x304x7 bf16 level, 97 us at
// 3.35 TB/s (half of that in int8, twice in f32). One comparison per value
// is nothing beside that, so the design is about keeping enough bytes in
// flight on every SM with few instructions per byte.
//
// Design, in the TPU kernel's order (conv3d.py:1830-1853: the D-pair max,
// the H-pair max, then the W-pair compaction). Output row (oz, oy) is the
// W-pair compaction of R, the element-wise max of the four input rows
// (2oz+a, 2oy+b), each W*C contiguous elements; rows 2oy and 2oy+1 of a
// plane are adjacent, so the four rows are two contiguous runs.
// - Loads: a persistent grid (at most 3 blocks an SM) walks the output
//   rows, block b taking rows b, b + grid, ..., so that all blocks read
//   neighbouring rows at any moment. A ring of STAGES stages in shared
//   memory, each holding the four input rows of one output row, is filled
//   by one thread's two 1-D TMA bulk copies (cp.async.bulk) per stage,
//   completing on the stage's mbarrier, so the next rows are in flight
//   while the block reduces the current one. TMA rather than 16-byte
//   cp.async: the copies cost the block's threads no issue slots (a stage
//   is 532-2128 cp.async per block at the path's shapes); on the H100 it
//   was as fast or faster at every shape a sweep of both tried, most in
//   int8, whose rows are shortest.
// - D-pair and H-pair max on 16-byte vectors, in place into the stage's
//   first row: int8 __vmaxs4, bf16 __hmax2_nan, f32 a compare-select that
//   keeps NaN (fmaxf would drop it).
// - W-pair compaction from shared memory: out[j] = max(R[2j - c],
//   R[2j - c + C]) with c = j mod C (j = ox*C + c), one element per thread
//   in turn so that neighbouring lanes read neighbouring words (no bank
//   conflicts), c stepped without divisions. The output row is staged in
//   shared memory and leaves with one 16-byte store per thread (8 bytes
//   where the row's bytes are 8 mod 16, as in int8 at 7 channels).
// - ops/kernels/conv3d.py::pool_plan picks the ring's depth, the store
//   width and the grid, never more blocks than output rows.
// - A row whose bytes are not a multiple of 16, or a volume not on a
//   16-byte boundary, takes the same kernel's scalar path (STAGES = 0): the
//   four rows are read element by element into R, then the same compaction.
//   No path shape needs it.
// No tensor cores: the TPU kernel took the W-pair max with two 0/1
// selection matmuls only because its VPU ran at 1/16 lane use otherwise; on
// the H100 a read from shared memory costs the byte stream nothing.
#include <string.h>

#include "common.cuh"
#include "mma.cuh"

using namespace ctunet;

namespace {

constexpr int POOL_THREADS = 256;
// the blocks ops/kernels/conv3d.py::pool_plan keeps on one SM at most
constexpr int POOL_MIN_BLOCKS = 3;

template <typename To, typename From>
__device__ __forceinline__ To bits(const From& v) {
  static_assert(sizeof(To) == sizeof(From), "a reinterpretation");
  To t;
  memcpy(&t, &v, sizeof(To));
  return t;
}

// Each pooled type's max of two values and of two 4-byte words of values.
struct Bf16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T max(T a, T b) {
    return __hmax_nan(a, b);
  }
  static __device__ __forceinline__ uint32_t max_word(uint32_t a,
                                                      uint32_t b) {
    return bits<uint32_t>(__hmax2_nan(bits<__nv_bfloat162>(a),
                                      bits<__nv_bfloat162>(b)));
  }
};

struct F32 {
  using T = float;
  static __device__ __forceinline__ float max(float a, float b) {
    return (a > b || a != a) ? a : b;  // a NaN on either side wins
  }
  static __device__ __forceinline__ uint32_t max_word(uint32_t a,
                                                      uint32_t b) {
    return __float_as_uint(max(__uint_as_float(a), __uint_as_float(b)));
  }
};

struct Int8 {
  using T = int8_t;
  static __device__ __forceinline__ T max(T a, T b) { return a > b ? a : b; }
  static __device__ __forceinline__ uint32_t max_word(uint32_t a,
                                                      uint32_t b) {
    return __vmaxs4(a, b);
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

template <typename P>
__device__ __forceinline__ uint4 max16(const uint4& a, const uint4& b) {
  return make_uint4(P::max_word(a.x, b.x), P::max_word(a.y, b.y),
                    P::max_word(a.z, b.z), P::max_word(a.w, b.w));
}

struct Params {
  const unsigned char* x;  // (D, H, W, C)
  unsigned char* out;      // (D/2, H/2, W/2, C)
  int D, H, W, C;
  int row_cap;  // bytes of one input row's slot in a stage
  int out_vec;  // bytes per output store: 16, 8, 4, 2 or 1
};

// n_bytes of the staged output row to global memory, sizeof(V) a store.
template <typename V>
__device__ __forceinline__ void store_row(unsigned char* g,
                                          const unsigned char* s,
                                          int n_bytes) {
  const int n = n_bytes / static_cast<int>(sizeof(V));
  for (int u = threadIdx.x; u < n; u += POOL_THREADS)
    reinterpret_cast<V*>(g)[u] = reinterpret_cast<const V*>(s)[u];
}

template <typename P, int STAGES>
__global__ void __launch_bounds__(POOL_THREADS, POOL_MIN_BLOCKS)
maxpool2_rows_kernel(const Params p) {
  using T = typename P::T;
  constexpr int SLOTS = STAGES > 0 ? STAGES : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[SLOTS];  // stage s's copies complete here
  const int H2 = p.H / 2;
  const int n_rows = (p.D / 2) * H2;
  // this block's output rows: blockIdx.x + k * gridDim.x, k < nk
  const int nk = (n_rows - static_cast<int>(blockIdx.x) +
                  static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
  const int64_t row_bytes = static_cast<int64_t>(p.W) * p.C * sizeof(T);
  const int n_out = (p.W / 2) * p.C;  // elements of an output row
  const int out_bytes = n_out * static_cast<int>(sizeof(T));
  const int stage_bytes = 4 * p.row_cap;
  unsigned char* out_s = smem + SLOTS * stage_bytes;

  auto row_of = [&](int k) { return blockIdx.x + k * gridDim.x; };
  // the first of the adjacent input rows (2oz + a, 2oy), (2oz + a, 2oy + 1)
  auto run = [&](int k, int a) {
    const int r = row_of(k), oz = r / H2, oy = r - oz * H2;
    return p.x + (static_cast<int64_t>(2 * oz + a) * p.H + 2 * oy) * row_bytes;
  };
  // row k's four input rows into stage k % STAGES (thread 0)
  auto issue = [&](int k) {
    if (k < nk && threadIdx.x == 0) {
      uint64_t* bar = &bars[k % SLOTS];
      mbar_expect(bar, static_cast<uint32_t>(4 * row_bytes));
      for (int a = 0; a < 2; ++a)
        bulk_load(smem + (k % SLOTS) * stage_bytes + a * 2 * p.row_cap,
                  run(k, a), static_cast<uint32_t>(2 * row_bytes), bar);
    }
  };

  if constexpr (STAGES > 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int k = 0; k < STAGES; ++k) issue(k);
  }
  const int c0 = static_cast<int>(threadIdx.x) % p.C;
  const int dc = POOL_THREADS % p.C;
  for (int k = 0; k < nk; ++k) {
    unsigned char* st = smem + (k % SLOTS) * stage_bytes;
    if constexpr (STAGES > 0) {
      mbar_wait(&bars[k % SLOTS], (k / STAGES) & 1);  // row k landed
      const int n16 = static_cast<int>(row_bytes / 16);
      const int step = p.row_cap / 16;
      uint4* s = reinterpret_cast<uint4*>(st);
      for (int v = threadIdx.x; v < n16; v += POOL_THREADS)
        s[v] = max16<P>(max16<P>(s[v], s[v + step]),
                        max16<P>(s[v + 2 * step], s[v + 3 * step]));
    } else {
      const T* a0 = reinterpret_cast<const T*>(run(k, 0));
      const T* a1 = reinterpret_cast<const T*>(run(k, 1));
      const int64_t w = static_cast<int64_t>(p.W) * p.C;
      T* R = reinterpret_cast<T*>(st);
      for (int i = threadIdx.x; i < 2 * n_out; i += POOL_THREADS)
        R[i] = P::max(P::max(a0[i], a0[w + i]), P::max(a1[i], a1[w + i]));
    }
    __syncthreads();  // R complete
    {
      const T* R = reinterpret_cast<const T*>(st);
      T* O = reinterpret_cast<T*>(out_s);
      int c = c0;
      for (int j = threadIdx.x; j < n_out; j += POOL_THREADS) {
        const int i = 2 * j - c;
        O[j] = P::max(R[i], R[i + p.C]);
        c += dc;
        c -= c >= p.C ? p.C : 0;
      }
    }
    // the stage's generic reads and writes before the copy that refills it
    if constexpr (STAGES > 0)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the stage is free, the output row staged
    if constexpr (STAGES > 0) issue(k + STAGES);
    unsigned char* g = p.out + static_cast<int64_t>(row_of(k)) * out_bytes;
    switch (p.out_vec) {
      case 16:
        store_row<uint4>(g, out_s, out_bytes);
        break;
      case 8:
        store_row<uint2>(g, out_s, out_bytes);
        break;
      case 4:
        store_row<uint32_t>(g, out_s, out_bytes);
        break;
      case 2:
        store_row<uint16_t>(g, out_s, out_bytes);
        break;
      default:
        store_row<uint8_t>(g, out_s, out_bytes);
    }
  }
}

template <typename P, int STAGES>
int launch(const Params& p, int grid, int smem, void* stream) {
  cudaError_t err = allow_smem(maxpool2_rows_kernel<P, STAGES>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch's check
    return static_cast<int>(err);
  }
  maxpool2_rows_kernel<P, STAGES>
      <<<grid, POOL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the plan against the volume (a wrong one would read or write out
// of bounds), then launches STAGES = stages.
template <typename P>
int entry(const void* x, void* out, int D, int H, int W, int C, int stages,
          int grid, int row_cap, int out_vec, int smem, int device,
          void* stream) {
  constexpr int64_t isz = sizeof(typename P::T);
  const int64_t n_rows = static_cast<int64_t>(D / 2) * (H / 2);
  const int64_t row = static_cast<int64_t>(W) * C * isz;
  const int64_t out_row = static_cast<int64_t>(W / 2) * C * isz;
  const int64_t need = static_cast<int64_t>(stages > 0 ? stages : 1) * 4 *
                           row_cap + (out_row + 15) / 16 * 16;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const bool vec_ok = row % 16 == 0 && row_cap == row && xa % 16 == 0;
  if (n_rows <= 0 || out_row <= 0 || grid <= 0 || grid > n_rows ||
      row_cap < row || row_cap % 16 || smem < need ||
      smem > static_cast<int64_t>(kMaxSmemPerBlock) || stages < 0 ||
      stages > 3 || (stages > 0 && !vec_ok) || out_vec < isz ||
      out_vec > 16 || (out_vec & (out_vec - 1)) || out_row % out_vec ||
      oa % out_vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{static_cast<const unsigned char*>(x),
                 static_cast<unsigned char*>(out), D, H, W, C, row_cap,
                 out_vec};
  switch (stages) {
    case 0:
      return launch<P, 0>(p, grid, smem, stream);
    case 1:
      return launch<P, 1>(p, grid, smem, stream);
    case 2:
      return launch<P, 2>(p, grid, smem, stream);
    default:
      return launch<P, 3>(p, grid, smem, stream);
  }
}

}  // namespace

#define POOL_ENTRY(NAME, P)                                                  \
  extern "C" int NAME(const void* x, void* out, int D, int H, int W, int C, \
                      int stages, int grid, int row_cap, int out_vec,       \
                      int smem, int device, void* stream) {                 \
    return entry<P>(x, out, D, H, W, C, stages, grid, row_cap, out_vec,     \
                    smem, device, stream);                                  \
  }

POOL_ENTRY(ctunet_maxpool2_rows, Bf16)
POOL_ENTRY(ctunet_maxpool2_rows_f32, F32)
POOL_ENTRY(ctunet_maxpool2_rows_q, Int8)
