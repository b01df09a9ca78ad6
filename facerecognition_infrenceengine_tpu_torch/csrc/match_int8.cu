// K2: fused int8 gallery top-1 (s8 q . s8 g^T with a running max/argmax on
// the raw s32), for sm_90a.
//
// Replaces the TPU kernel facerecognition_infrenceengine_tpu/ops/
// match_pallas.py:235 gallery_top1_int8 (body _top1_int8_kernel, :200).
// Same function: the gallery is int8 with one global scale and the queries
// are int8 with one per-batch scale, so the raw s32 dot is monotonic in the
// true score for every row.  For each query: the largest raw dot over rows
// [0, n_valid) and its row; rows >= n_valid are never read; the lowest
// index wins a tie; with no valid row the value is -inf and the index 0;
// the value is float(raw) * (query scale * gallery scale).  The query
// quantization is the reference's: qs = max(max|q|, 1e-12) / 127 over the
// whole batch, q_int = clip(rint(q / qs), -127, 127), with IEEE division.
// All else is integer (exact in any order), so the result equals the plain
// version bit for bit.
//
// Bound on the H100: bytes at small batch.  The n_valid x 512 int8 gallery
// is read once (25.6 MB at 50,000 rows: 7.6 us at 3.35 TB/s); the
// 2*B*n_valid*512 operations take 0.83 us at B = 32 and 6.6 us at B = 256
// at the 1,979 TOP/s int8 tensor-core rate.  No [B, N] score tensor
// reaches device memory.
//
// Design: one launch a call on a persistent grid (as many blocks as fit on
// the card; the occupancy is cached per tile size), so the gallery crosses
// HBM once a call for B <= 256; larger batches (bucketed to multiples of
// 256) walk it once a 256-query tile.
// - The query scale needs every block to see the whole batch.  Up to B = 32
//   each block reads all of it (64 KB, from L2) and derives qs itself -- a
//   max is order-free, so every block gets the same qs bit for bit -- and
//   quantizes its tile.  Above that this would read 512 KB a block at
//   B = 256, so the launch is cooperative: each block folds the max|q| of a
//   slice into one word by atomicMax (non-negative floats order as their
//   bits), and after a grid.sync() quantizes its slice into a B x 512 s8
//   scratch; after a second grid.sync() each block copies its tile from
//   L2.  At B <= 32 the two barriers measured slower than the redundant
//   reads, and above it faster.  Either way the tile lands in shared memory
//   with 16-byte chunks XOR-swizzled by row parity, so the fragment loads
//   are conflict-free.
// - Tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32, M = 16 queries, N = 8
//   rows, K = 32 bytes.  K is permuted the same way in both operands -- lane
//   (g, t) takes bytes 64c + 16t .. +15 of its row for k-steps 2c and
//   2c + 1 -- so a lane's gallery fragment for two k-steps is one 16-byte
//   load of a row, and its query fragment one 16-byte shared-memory load.
//   A warp holds a unit of 32 gallery rows (4 n-tiles, the whole K: 128
//   registers) and runs every 16-query m-tile of the tile over them, so a
//   query fragment feeds 8 MMAs.  Units are dealt warp-major (unit w *
//   gridDim.x + block), so a tail of units spreads over all SMs.
// - The merge is in the same launch.  A lane folds its 8 candidates a
//   query, and the 4 lanes of a quad theirs, as raw * 32 + (31 - the row's
//   place in the unit) with integer max (the largest raw, then the lowest
//   row); each warp keeps a 64-bit key a query in shared memory -- high
//   word (uint32)raw ^ 0x80000000 (s32 order as unsigned order), low word
//   ~row (the lower row wins); 0 means no row -- and the block folds its
//   warps' keys into the call's by one global atomicMax a query.  The last
//   block to finish decodes and scales the keys and leaves keys, counter
//   and max word at zero.
// - Streaming: a warp's next unit is prefetched into L2 by one bulk
//   prefetch while it works on the current one (with the grid barriers,
//   its first two before them), so HBM stays busy between a warp's
//   register loads.  Holding two m-tiles' accumulators at once (more MMA
//   chains, 250 registers) and the evict-first loads of the first version
//   measured slower.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDim = 512;                  // bytes a row
constexpr int kQueryTile = 256;            // queries a block stages
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTiles = 4;                  // n-tiles of 8 rows a warp unit
constexpr int kUnitRows = 8 * kTiles;      // 32 rows a warp unit
constexpr int kChunks = kDim / 64;         // 64-byte chunks: 2 k-steps each
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kQueryTile, "one thread a query for the merge");
// up to this batch every block reads the whole f32 batch (64 KB) to derive
// qs itself: cheaper than two grid barriers
constexpr int kOwnScaleMaxB = 32;

// c += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators
__device__ __forceinline__ void mma_s8(int c[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk ch of staged query row m
__device__ __forceinline__ int q_off(int m, int ch) {
  return m * kDim + ((ch ^ ((m & 1) << 2)) << 4);
}

// (raw, row) as a key whose unsigned order is raw first, then the lower row
__device__ __forceinline__ unsigned long long pack_best(int raw, int row) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(raw) ^ 0x80000000u) << 32) |
         static_cast<unsigned>(~row);
}

__device__ __forceinline__ unsigned quantize4(float4 x, float qs) {
  const float v[4] = {x.x, x.y, x.z, x.w};
  unsigned word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[k], qs)), -127.0f), 127.0f);  // half to even
    word |= (static_cast<unsigned>(static_cast<int>(r)) & 0xffu) << (8 * k);
  }
  return word;
}

// kGridScale: co-resident blocks (cooperative launch) share the query
// scale through state[0] and the s8 batch through q_int; otherwise (b <=
// kOwnScaleMaxB) every block derives qs from the whole batch and quantizes
// its tile itself.  Dynamic shared memory: one query tile as s8, 16 *
// ceil(min(256, b) / 16) rows of 512 bytes.  state[0]: the batch's max|q|
// bits, state[1]: blocks done; both zero between calls.
template <bool kGridScale>
__global__ void __launch_bounds__(kThreads, 1)
top1_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ g, float gallery_scale,
                 int b, int n_rows, unsigned* state, unsigned* q_int,
                 unsigned long long* keys, float* __restrict__ out_val,
                 int* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char s_q[];
  __shared__ unsigned long long s_best[kWarps][kQueryTile];  // each warp's keys
  __shared__ float s_max[kWarps];
  __shared__ bool s_last;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, quad = lane & 3;
  const int units = (n_rows + kUnitRows - 1) / kUnitRows;
  const int unit0 = warp * gridDim.x + blockIdx.x;
  const int unit_stride = gridDim.x * kWarps;

  // this lane's B fragments of a unit: rows row0 + 8j + grp, bytes
  // 64c + 16 quad .. +15; rows past n_rows read as zero
  uint4 bv[kTiles][kChunks];
  auto load_unit = [&](int u) {
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int row = u * kUnitRows + 8 * j + grp;
      const uint4* p =
          reinterpret_cast<const uint4*>(g + static_cast<size_t>(row < n_rows ? row : 0) * kDim) +
          quad;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        bv[j][c] = row < n_rows ? __ldg(p + 4 * c) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  // a unit's rows into L2 with one bulk prefetch (the rows are contiguous)
  auto prefetch_unit = [&](int u) {
    if (lane == 0 && u < units) {
      const int rows = min(kUnitRows, n_rows - u * kUnitRows);
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(
                       g + static_cast<size_t>(u) * kUnitRows * kDim),
                   "r"(rows * kDim)
                   : "memory");
    }
  };
  if constexpr (kGridScale) {
    // the warp's first two units stream into L2 across the grid barriers
    // (register loads issued here would queue the staging behind them)
    prefetch_unit(unit0);
    prefetch_unit(unit0 + unit_stride);
  }

  // qs: max|q| over this block's slice of the batch (kGridScale), folded
  // into state[0], or over the whole batch
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const int n4 = b * (kDim / 4);
  const int first4 = kGridScale ? blockIdx.x * kThreads + threadIdx.x : threadIdx.x;
  const int stride4 = kGridScale ? gridDim.x * kThreads : kThreads;
  float m = 0.0f;
  for (int i = first4; i < n4; i += stride4) {
    const float4 x = __ldg(q4 + i);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  m = s_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_max[w]);
  if constexpr (kGridScale) {
    cg::grid_group grid = cg::this_grid();
    if (threadIdx.x == 0) atomicMax(state, __float_as_uint(m));  // m >= 0: bits order as values
    grid.sync();
    m = __uint_as_float(__ldcg(state));
  }
  const float qs = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
  if constexpr (kGridScale) {
    for (int i = first4; i < n4; i += stride4) q_int[i] = quantize4(__ldg(q4 + i), qs);
    cg::this_grid().sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) state[0] = 0u;  // every block has read it
  }

  const uint4* qi4 = reinterpret_cast<const uint4*>(q_int);
  for (int q0 = 0; q0 < b; q0 += kQueryTile) {
    const int nq = min(kQueryTile, b - q0);
    const int mtiles = (nq + 15) / 16;
    // stage the tile's s8 rows, 16-byte chunk ch of row r: from q_int
    // (written by other blocks: read through L2) or quantized here; rows
    // past nq are zero
#pragma unroll 8
    for (int i = threadIdx.x; i < mtiles * 16 * (kDim / 16); i += kThreads) {
      const int r = i / (kDim / 16), ch = i % (kDim / 16);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nq) {
        if constexpr (kGridScale) {
          v = __ldcg(qi4 + static_cast<size_t>(q0 + r) * (kDim / 16) + ch);
        } else {
          const float4* src = q4 + static_cast<size_t>(q0 + r) * (kDim / 4) + 4 * ch;
          v = make_uint4(quantize4(__ldg(src), qs), quantize4(__ldg(src + 1), qs),
                         quantize4(__ldg(src + 2), qs), quantize4(__ldg(src + 3), qs));
        }
      }
      *reinterpret_cast<uint4*>(s_q + q_off(r, ch)) = v;
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s_best[w][threadIdx.x] = 0ull;
    __syncthreads();

    int unit = unit0;
    if (unit < units) load_unit(unit);
    while (unit < units) {
      const int row0 = unit * kUnitRows;
#pragma unroll 1
      for (int mt = 0; mt < mtiles; ++mt) {
        int acc[kTiles][4];
#pragma unroll
        for (int j = 0; j < kTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const uint4 ag =
              *reinterpret_cast<const uint4*>(s_q + q_off(16 * mt + grp, 4 * c + quad));
          const uint4 ah =
              *reinterpret_cast<const uint4*>(s_q + q_off(16 * mt + grp + 8, 4 * c + quad));
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            mma_s8(acc[j], ag.x, ah.x, ag.y, ah.y, bv[j][c].x, bv[j][c].y);
            mma_s8(acc[j], ag.z, ah.z, ag.w, ah.w, bv[j][c].z, bv[j][c].w);
          }
        }
        // a lane's C entries: queries 16mt + grp (+ 8), unit rows 8j + 2quad (+ 1).
        // A candidate is raw * 32 + (31 - its row in the unit) (exact: |raw|
        // < 2^23), so one integer max keeps the largest raw, then the lowest row.
        const bool full = row0 + kUnitRows <= n_rows;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int best = INT_MIN;
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 8 * j + 2 * quad + e;
              const int cand = acc[j][2 * h + e] * 32 + (31 - r);
              best = max(best, full || row0 + r < n_rows ? cand : INT_MIN);
            }
          }
          best = max(best, __shfl_xor_sync(kFull, best, 1));  // the quad's 4 lanes
          best = max(best, __shfl_xor_sync(kFull, best, 2));
          if (quad == 0 && best != INT_MIN) {  // only this lane writes this slot
            const unsigned long long key = pack_best(best >> 5, row0 + 31 - (best & 31));
            unsigned long long& slot = s_best[warp][16 * mt + grp + 8 * h];
            if (key > slot) slot = key;
          }
        }
      }
      unit += unit_stride;
      if (unit < units) {
        load_unit(unit);
        prefetch_unit(unit + unit_stride);
      }
    }
    __syncthreads();
    if (threadIdx.x < nq) {
      unsigned long long key = s_best[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const unsigned long long other = s_best[w][threadIdx.x];
        key = other > key ? other : key;
      }
      if (key != 0ull) atomicMax(keys + q0 + threadIdx.x, key);
    }
    __syncthreads();  // s_q and s_best are restaged for the next tile
  }

  // the last block to finish decodes the keys and resets keys and counter
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(state + 1, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  for (int k = threadIdx.x; k < b; k += kThreads) {
    const unsigned long long key = atomicExch(keys + k, 0ull);
    const int raw = static_cast<int>(static_cast<unsigned>(key >> 32) ^ 0x80000000u);
    // exact: |raw| < 2^24; -inf stays -inf under the positive scale
    out_val[k] = (key == 0ull ? -INFINITY : static_cast<float>(raw)) * __fmul_rn(qs, gallery_scale);
    out_idx[k] = key == 0ull ? 0 : static_cast<int>(~static_cast<unsigned>(key));
  }
  if (threadIdx.x == 0) state[1] = 0u;
}

constexpr int kMaxBlocksPerSm = 4;
constexpr int kMaxDevices = 64;
constexpr int kMaxMTiles = kQueryTile / 16;

// Per device: its SM count and, for each form (0 own scale, 1 grid
// scale), the blocks an SM at each m-tile count of the staged tile (0: not
// asked yet).  The first launch on a device raises both forms'
// shared-memory limit to the largest tile's.
struct DeviceCache {
  int sms = 0;
  int per_sm[2][kMaxMTiles + 1] = {};
};
DeviceCache g_cache[kMaxDevices];

int staged_bytes(int mtiles) { return mtiles * 16 * kDim; }

}  // namespace

// rows a warp unit: the gallery's chunking
extern "C" int fre_gallery_top1_int8_rows_per_block() { return kUnitRows; }

// q [b, 512] f32 and g [>= n_rows, 512] int8, contiguous and 16-byte
// aligned; state [2] u32 and keys [b] u64, zero before the first call (each
// call leaves them zero); q_int [b, 512] s8 scratch.  Writes the scaled
// best dot (-inf with no row) to out_val [b] and its row to out_idx [b].
// One launch: cooperative for b > kOwnScaleMaxB.
extern "C" int fre_gallery_top1_int8(const void* q, const void* g, float gallery_scale, int b,
                                     int n_rows, void* state, void* q_int, void* keys,
                                     float* out_val, int* out_idx, void* stream) {
  if (b <= 0) return 0;
  if (n_rows < 0 || static_cast<long long>(b) * kDim > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceCache& cache = g_cache[dev];
  if (cache.sms == 0) {
    err = cudaDeviceGetAttribute(&cache.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(top1_int8_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 staged_bytes(kMaxMTiles));
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(top1_int8_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 staged_bytes(kMaxMTiles));
    }
    if (err != cudaSuccess) {
      cache.sms = 0;
      return static_cast<int>(err);
    }
  }
  const bool grid_scale = b > kOwnScaleMaxB;
  void (*kernel)(const float*, const int8_t*, float, int, int, unsigned*, unsigned*,
                 unsigned long long*, float*, int*) =
      grid_scale ? top1_int8_kernel<true> : top1_int8_kernel<false>;
  const int mtiles = (min(b, kQueryTile) + 15) / 16;
  int& per_sm = cache.per_sm[grid_scale][mtiles];
  if (per_sm == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        staged_bytes(mtiles));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    per_sm = min(n, kMaxBlocksPerSm);
  }
  // co-resident blocks (grid.sync), and no more than the units need
  const int units = (n_rows + kUnitRows - 1) / kUnitRows;
  const int blocks = max(1, min((units + kWarps - 1) / kWarps, per_sm * cache.sms));
  const float* qf = static_cast<const float*>(q);
  const int8_t* g8 = static_cast<const int8_t*>(g);
  unsigned* st = static_cast<unsigned*>(state);
  unsigned* qi = static_cast<unsigned*>(q_int);
  unsigned long long* k64 = static_cast<unsigned long long*>(keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid_scale) {
    void* args[] = {&qf, &g8, &gallery_scale, &b, &n_rows, &st, &qi, &k64, &out_val, &out_idx};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                      dim3(kThreads), args, staged_bytes(mtiles), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    kernel<<<blocks, kThreads, staged_bytes(mtiles), s>>>(qf, g8, gallery_scale, b, n_rows, st,
                                                         qi, k64, out_val, out_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
