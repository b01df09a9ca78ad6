// K1: fused gallery top-1 (q . g^T with a running max/argmax), for sm_90a.
//
// Replaces the TPU kernel facerecognition_infrenceengine_tpu/ops/
// match_pallas.py:79 gallery_top1 (body _top1_kernel, :47).  Same function:
// for each query the best f32-accumulated dot product over gallery rows
// [0, n_valid) and its row index; rows >= n_valid are never read (masked
// by index); the lowest index wins a tie; with no valid row the value is
// -inf and the index 0.  Queries arrive in f32 and are rounded to the
// gallery's dtype (f32 or bf16) as the kernel stages them; products are
// exact and sums f32, never TF32.
//
// Bound on the H100: at small batch, bytes (the n_valid x 512 gallery read
// once: 102.4 MB in f32 at 50,000 rows, 30.6 us at 3.35 TB/s; 15.3 us in
// bf16); at large batch, operations (2*B*n_valid*512: in f32 24.5 us at
// B = 32 and 196 us at B = 256 on the 67 TFLOP/s FP32 cores).  No [B, N]
// score tensor reaches device memory.
//
// Both kernels read the gallery from HBM once for every 32 queries: a
// block stages up to 32 queries in shared memory, and the grid is
// persistent -- as many blocks as fit on the card for each tile of 32
// queries -- each block walking row chunks c, c + gridDim.x, ...  Each
// block folds its (max, lowest row) for each query into a 64-bit key with
// one atomicMax (ordered by value, then the lower row), and the last block
// of a query tile to finish decodes the keys: a call is one launch.  In both the summation order
// of a dot does not depend on where its row sits, so equal rows give
// bit-equal scores and the lowest-index rule is exact.
//
// f32 (top1_f32_kernel), on the FP32 cores: each warp takes 4 rows of a
// 32-row chunk and each lane holds 16 elements of each of the 4 rows in
// registers (one coalesced 512-byte load a row a warp), so one 16-byte
// shared-memory load of 4 query values feeds 16 FMAs.  For each group of 4
// queries a lane builds 16 partial dots (4 queries x 4 rows), 16 chains
// interleaved, and a transposing warp reduction leaves each lane pair with
// one (query, row) dot in 16 shuffles; the query bits of a lane's partials
// are permuted by the query it ends with, which spares half the selects.
// A dot is each lane's 16-element FFMA chain in element order, then the
// fixed cross-lane tree over lane offsets 16, 8, 4, 2, 1: the order of the
// earlier kernel, whose values this one equals bit for bit.  A block's
// first rows load while it stages its queries.  64 registers hold the rows
// and 16 the partials; the running bests live in shared memory.
// __launch_bounds__(256, 2) holds a thread to 128 registers: two blocks
// (16 warps) an SM with their 2 x 64 KB of queries.  A (query, row) pair
// costs ~22 warp instructions (16 FFMA), and the query loads move as many
// shared-memory bytes as the FP32 pipe allows: at B >= 32 the kernel is
// bound by instruction issue and latency (measured on an H100 at 700 W:
// ~53% of the FP32 peak at B = 256).  Holding 8 rows a warp (half the
// shared-memory traffic, 8-12 warps an SM), double-buffering the rows in
// registers or in shared memory (cp.async) and an L2 prefetch of the next
// chunk all measured slower.
//
// bf16 (top1_bf16_kernel), on the tensor cores: mma.sync.m16n8k16 bf16 ->
// f32 with M = 16 queries, N = 8 rows, K = 16 elements.  K is permuted the
// same way for both operands -- lane l of an MMA takes elements
// 32c + 8(l%4) .. +7 of its row for k-steps 2c and 2c + 1 -- so a lane's B
// fragment of 8 rows is one 16-byte load of a gallery row, and its A
// fragment one 16-byte load of a query row from shared memory (queries
// stored bf16, 16-byte chunks XOR-swizzled by the row).  Each warp takes 32
// rows (4 n-tiles) of a 128-row chunk and runs 2 x 4 x 32 MMAs for 32
// queries, loading the next 32 elements of its rows while the MMAs of the
// current ones run.  A dot's order -- 32 k-steps in sequence, each a fixed
// 16-term MMA -- is the same at every position of the tile.  At B <= 32
// the tensor cores are idle most of the time: the kernel is bound by the
// gallery's bytes (an L2 prefetch of the next chunk measured slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDim = 512;
constexpr int kQueryTile = 32;   // queries a block stages
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ----------------------------------------------------------------- merge
// A (value, row) pair as one 64-bit key whose unsigned order is value
// first, then the lower row: the float's bits made order-preserving (-0 is
// taken as +0, as float equality has it), then the row's complement.
__device__ __forceinline__ unsigned long long pack_best(float v, int row) {
  const unsigned bits = __float_as_uint(v + 0.0f);
  const unsigned hi = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(hi) << 32) | static_cast<unsigned>(~row);
}

// Each block folds its best (value, row) for query q0 + k into keys[q0 + k]
// with one atomicMax; the last block of the query tile to finish (counted
// in done[blockIdx.y]) decodes the tile's keys into the outputs and resets
// keys and counter to zero for the next launch.  No valid row: -inf and
// index 0.
__device__ void publish_best(float bv, int bi, int q0, int nq, unsigned long long* keys,
                             int* done, float* out_val, int* out_idx) {
  __shared__ bool s_last;
  if (threadIdx.x < nq) atomicMax(keys + q0 + threadIdx.x, pack_best(bv, bi));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(done + blockIdx.y, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  if (threadIdx.x < nq) {
    const unsigned long long key = atomicExch(keys + q0 + threadIdx.x, 0ull);
    const unsigned hi = static_cast<unsigned>(key >> 32);
    const int row = static_cast<int>(~static_cast<unsigned>(key));
    out_val[q0 + threadIdx.x] = __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
    out_idx[q0 + threadIdx.x] = row == INT_MAX ? 0 : row;
  }
  if (threadIdx.x == 0) done[blockIdx.y] = 0;
}

// ------------------------------------------------------------------- f32
constexpr int kWarps = 8;
constexpr int kRows = 4;                         // gallery rows a warp holds
constexpr int kRowsPerChunk = kWarps * kRows;    // 32
constexpr int kGroup = 4;                        // queries a reduction group
constexpr int kGroups = kQueryTile / kGroup;     // 8
constexpr int kPerLane = kDim / 32;              // 16 elements a lane a row
static_assert(kGroup == 4 && kRows == 4, "transpose_reduce takes 4 queries x 4 rows");

// One halving exchange over lane offset `off`.  kXor: every lane keeps
// a[0, half) and sends a[half, 2*half), which works because the slots hold
// pairs XOR-permuted by the lane (see top1_f32_kernel), so the partner's
// sent slot i holds the same pair as the lane's slot i.  Otherwise lanes
// with bit `off` set keep the upper half and send the lower.  Each kept
// value gains the partner's.  Constant indices only: a[] stays in
// registers.
template <int half, bool kXor>
__device__ __forceinline__ void halve(float a[], int lane, int off) {
#pragma unroll
  for (int i = 0; i < half; ++i) {
    if (kXor) {
      a[i] += __shfl_xor_sync(kFull, a[i + half], off);
    } else {
      const bool hi = lane & off;
      const float lo_v = a[i], hi_v = a[i + half];
      a[i] = (hi ? hi_v : lo_v) + __shfl_xor_sync(kFull, hi ? lo_v : hi_v, off);
    }
  }
}

// a[4k + r] holds this lane's partial dot of (query k ^ my_q, row r).  Lane
// l ends with the full dot of query my_q = (l >> 3) & 3, row (l >> 1) & 3,
// summed over lane offsets 16, 8, 4, 2 and then 1.
__device__ __forceinline__ float transpose_reduce(float a[kGroup * kRows], int lane) {
  halve<8, true>(a, lane, 16);
  halve<4, true>(a, lane, 8);
  halve<2, false>(a, lane, 4);
  halve<1, false>(a, lane, 2);
  return a[0] + __shfl_xor_sync(kFull, a[0], 1);
}

// lane l holds elements 128*c + 4*l + j (c < 4, j < 4) as v[4c + j]; the
// queries sit in shared memory in element order, so lane l's 4 values of
// chunk c are one 16-byte load and the lanes read consecutive 16 bytes.
// The gallery is read once: streaming loads (evict first).
__device__ __forceinline__ void load_row(const float* p, int lane, float v[kPerLane]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p + 128 * c + 4 * lane));
    v[4 * c + 0] = x.x;
    v[4 * c + 1] = x.y;
    v[4 * c + 2] = x.z;
    v[4 * c + 3] = x.w;
  }
}

// grid (blocks, query tiles of 32); dynamic shared memory: the tile's
// queries, 4 * ceil(min(32, b) / 4) x 512 f32.
__global__ void __launch_bounds__(kWarps * 32, 2)
top1_f32_kernel(const float* __restrict__ q, const float* __restrict__ g, int b, int n_rows,
                unsigned long long* keys, int* done, float* __restrict__ out_val,
                int* __restrict__ out_idx) {
  extern __shared__ __align__(16) float4 sq4[];
  __shared__ float s_best_val[kGroups][kWarps * 32];
  __shared__ int s_best_idx[kGroups][kWarps * 32];
  const int q0 = blockIdx.y * kQueryTile;
  const int nq = min(kQueryTile, b - q0);
  const int groups = (nq + kGroup - 1) / kGroup;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Accumulator slot 4k + r of this lane is the pair (query 4g + (k ^ my_q),
  // row row0 + r) of group g: the query bits are XOR-permuted by the query
  // the lane ends with, so the reduction's first two levels need no
  // selects; the rows stay in order, so a row loads as 512 contiguous bytes.
  const int my_q = (lane >> 3) & 3;
  const int my_r = (lane >> 1) & 3;
  const int chunks = (n_rows + kRowsPerChunk - 1) / kRowsPerChunk;
  float gv[kRows][kPerLane];
  auto load_rows = [&](int row0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row < n_rows) {
        load_row(g + static_cast<size_t>(row) * kDim, lane, gv[r]);
      } else {
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) gv[r][e] = 0.0f;
      }
    }
  };
  // the first chunk's rows are in flight while the queries are staged
  if (blockIdx.x < chunks) load_rows(blockIdx.x * kRowsPerChunk + warp * kRows);

  // stage the tile's queries; the last group's missing queries are zero
  const float4* qt = reinterpret_cast<const float4*>(q + static_cast<size_t>(q0) * kDim);
#pragma unroll 4
  for (int i = threadIdx.x; i < groups * kGroup * (kDim / 4); i += kWarps * 32) {
    sq4[i] = i / (kDim / 4) < nq ? __ldg(qt + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // each thread's running (max, row) for group g sits at s_best_*[g][thread]
  for (int gi = 0; gi < kGroups; ++gi) {
    s_best_val[gi][threadIdx.x] = -INFINITY;
    s_best_idx[gi][threadIdx.x] = INT_MAX;
  }
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int row0 = c * kRowsPerChunk + warp * kRows;
    if (c != blockIdx.x) load_rows(row0);
    const bool valid = row0 + my_r < n_rows;
#pragma unroll 1
    for (int gi = 0; gi < groups; ++gi) {
      const float4* qg = sq4 + gi * kGroup * (kDim / 4) + lane;
      float acc[kGroup * kRows];
#pragma unroll
      for (int i = 0; i < kGroup * kRows; ++i) acc[i] = 0.0f;
      float4 qq[kGroup], qn[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) qq[k] = qg[(k ^ my_q) * (kDim / 4)];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {  // element order: v[4ch + j] ascending
        if (ch < 3) {  // the next chunk's query values load under these FMAs
#pragma unroll
          for (int k = 0; k < kGroup; ++k) qn[k] = qg[(k ^ my_q) * (kDim / 4) + (ch + 1) * 32];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // 16 independent chains a step
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            const float qv = j == 0 ? qq[k].x : j == 1 ? qq[k].y : j == 2 ? qq[k].z : qq[k].w;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc[k * kRows + r] = fmaf(qv, gv[r][4 * ch + j], acc[k * kRows + r]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) qq[k] = qn[k];
      }
      const float score = transpose_reduce(acc, lane);
      if (valid && score > s_best_val[gi][threadIdx.x]) {  // a lane's rows rise: '>'
        s_best_val[gi][threadIdx.x] = score;                // keeps the lowest
        s_best_idx[gi][threadIdx.x] = row0 + my_r;
      }
    }
  }
  __syncthreads();
  float bv = -INFINITY;
  int bi = INT_MAX;
  if (threadIdx.x < nq) {  // query k: lane pairs 8 (k % 4) + 2r of every warp
    const int k = threadIdx.x;
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int t = w * 32 + 8 * (k % kGroup) + 2 * r;
        const float v = s_best_val[k / kGroup][t];
        const int ix = s_best_idx[k / kGroup][t];
        if (better(v, ix, bv, bi)) {
          bv = v;
          bi = ix;
        }
      }
    }
  }
  publish_best(bv, bi, q0, nq, keys, done, out_val, out_idx);
}

// ------------------------------------------------------------------ bf16
constexpr int kMmaWarps = 4;
constexpr int kTiles = 4;                                  // n-tiles (8 rows) a warp
constexpr int kWarpRows = 8 * kTiles;                      // 32
constexpr int kMmaRowsPerChunk = kMmaWarps * kWarpRows;    // 128
constexpr int kMTiles = kQueryTile / 16;                   // 2

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 w = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&w);
}

// 16-byte chunk ch (elements 8ch .. 8ch+7) of staged query row m
__device__ __forceinline__ int q_chunk(int m, int ch) { return m * (kDim / 8) + (ch ^ (m & 7)); }

// grid (blocks, query tiles of 32); dynamic shared memory: the tile's
// queries as bf16, 16 * ceil(min(32, b) / 16) rows of 1 KB.
__global__ void __launch_bounds__(kMmaWarps * 32)
top1_bf16_kernel(const float* __restrict__ q, const uint16_t* __restrict__ g, int b,
                 int n_rows, unsigned long long* keys, int* done,
                 float* __restrict__ out_val, int* __restrict__ out_idx) {
  extern __shared__ __align__(16) uint4 s_qb[];
  __shared__ float s_val[kMmaWarps][kQueryTile][4];
  __shared__ int s_idx[kMmaWarps][kQueryTile][4];
  const int q0 = blockIdx.y * kQueryTile;
  const int nq = min(kQueryTile, b - q0);
  const int mtiles = (nq + 15) / 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3, grp = lane >> 2;

  // stage the queries rounded to bf16 (the plain version's cast); rows
  // past nq are zero
  for (int i = threadIdx.x; i < mtiles * 16 * (kDim / 8); i += kMmaWarps * 32) {
    const int m = i / (kDim / 8), ch = i % (kDim / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < nq) {
      const float4* src =
          reinterpret_cast<const float4*>(q + static_cast<size_t>(q0 + m) * kDim + 8 * ch);
      const float4 lo = __ldg(src), hi = __ldg(src + 1);
      v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                     pack_bf16(hi.z, hi.w));
    }
    s_qb[q_chunk(m, ch)] = v;
  }
  __syncthreads();

  // a lane's C entries: queries 16i + grp (+ 8), rows 8j + 2*quad (+ 1)
  float best[kMTiles][2];
  int best_idx[kMTiles][2];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
    best[i][0] = best[i][1] = -INFINITY;
    best_idx[i][0] = best_idx[i][1] = INT_MAX;
  }
  const int chunks = (n_rows + kMmaRowsPerChunk - 1) / kMmaRowsPerChunk;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int row0 = c * kMmaRowsPerChunk + warp * kWarpRows;
    // this lane's B rows: row0 + 8j + grp; rows past n_rows read as zero
    const uint4* gp[kTiles];
    bool live[kTiles];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int row = row0 + 8 * j + grp;
      live[j] = row < n_rows;
      gp[j] = reinterpret_cast<const uint4*>(g + static_cast<size_t>(live[j] ? row : 0) * kDim) +
              quad;
    }
    float acc[kMTiles][kTiles][4];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
      }
    }
    uint4 bv[kTiles];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) bv[j] = live[j] ? __ldg(gp[j]) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 2
    for (int kc = 0; kc < kDim / 32; ++kc) {  // 32 elements: k-steps 2kc, 2kc + 1
      uint4 bn[kTiles];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        bn[j] = (live[j] && kc + 1 < kDim / 32) ? __ldg(gp[j] + 4 * (kc + 1))
                                                : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        if (i >= mtiles) break;
        const uint4 ax = s_qb[q_chunk(16 * i + grp, 4 * kc + quad)];
        const uint4 ay = s_qb[q_chunk(16 * i + grp + 8, 4 * kc + quad)];
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          mma_bf16(acc[i][j], ax.x, ay.x, ax.y, ay.y, bv[j].x, bv[j].y);
          mma_bf16(acc[i][j], ax.z, ay.z, ax.w, ay.w, bv[j].z, bv[j].w);
        }
      }
#pragma unroll
      for (int j = 0; j < kTiles; ++j) bv[j] = bn[j];
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {  // a lane's rows rise: '>' keeps the lowest
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 8 * j + 2 * quad + (e & 1);
          if (row < n_rows && acc[i][j][e] > best[i][e >> 1]) {
            best[i][e >> 1] = acc[i][j][e];
            best_idx[i][e >> 1] = row;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s_val[warp][16 * i + grp + 8 * h][quad] = best[i][h];
      s_idx[warp][16 * i + grp + 8 * h][quad] = best_idx[i][h];
    }
  }
  __syncthreads();
  float bvv = -INFINITY;
  int bi = INT_MAX;
  if (threadIdx.x < nq) {
    const int k = threadIdx.x;
    for (int w = 0; w < kMmaWarps; ++w) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (better(s_val[w][k][r], s_idx[w][k][r], bvv, bi)) {
          bvv = s_val[w][k][r];
          bi = s_idx[w][k][r];
        }
      }
    }
  }
  publish_best(bvv, bi, q0, nq, keys, done, out_val, out_idx);
}

constexpr int kMaxBlocksPerSm = 16;
constexpr int kMaxDevices = 64;

// Per device: its SM count, and for each pass-1 kernel (0 f32, 1 bf16) the
// blocks an SM at each query-tile size (0: not asked yet).  The first
// launch of a kernel on a device raises its shared-memory limit to the
// largest tile's; later launches make no attribute or occupancy calls.
struct DeviceCache {
  int sms = 0;
  int per_sm[2][kQueryTile + 1] = {};
};
DeviceCache g_cache[kMaxDevices];

DeviceCache* device_cache() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return nullptr;
  DeviceCache* c = &g_cache[dev];
  if (c->sms == 0 &&
      cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    c->sms = 0;
    return nullptr;
  }
  return c;
}

// One launch on a persistent grid: as many blocks as fit on the card (at
// most kMaxBlocksPerSm an SM) for each query tile, at least one (which, with
// no row, writes -inf and index 0).  staged_bytes(t) is the dynamic shared
// memory for a tile of t queries.
template <typename G, typename Bytes>
cudaError_t launch(void (*kernel)(const float*, const G*, int, int, unsigned long long*, int*,
                                  float*, int*),
                   int kind, int threads, Bytes staged_bytes, const float* q, const G* g, int b,
                   int n_rows, int rows_per_chunk, unsigned long long* keys, int* done,
                   float* out_val, int* out_idx, cudaStream_t s) {
  DeviceCache* cache = device_cache();
  if (cache == nullptr) return cudaErrorInvalidDevice;
  const int tile = min(b, kQueryTile);
  int& per_sm = cache->per_sm[kind][tile];
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, staged_bytes(kQueryTile));
    int n = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                          staged_bytes(tile));
    }
    if (err != cudaSuccess) return err;
    per_sm = min(max(n, 1), kMaxBlocksPerSm);
  }
  const int chunks = (n_rows + rows_per_chunk - 1) / rows_per_chunk;
  const int qtiles = (b + kQueryTile - 1) / kQueryTile;
  const int blocks = max(1, min(chunks, per_sm * cache->sms / qtiles));
  kernel<<<dim3(blocks, qtiles), threads, staged_bytes(tile), s>>>(
      q, g, b, n_rows, keys, done, out_val, out_idx);
  return cudaGetLastError();
}

int f32_bytes(int tile) { return (tile + kGroup - 1) / kGroup * kGroup * kDim * 4; }
int bf16_bytes(int tile) { return (tile + 15) / 16 * 16 * kDim * 2; }

}  // namespace

extern "C" int fre_gallery_top1_rows_per_block() { return kRowsPerChunk; }

// q [b, 512] f32; g [>= n_rows, 512] f32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1); both contiguous and 16-byte aligned; keys [b] u64 and done
// [ceil(b / 32)] int32, zero before the first call (each call leaves them
// zero).  Writes out_val [b] f32 and out_idx [b] int32.
extern "C" int fre_gallery_top1(const void* q, const void* g, int is_bf16, int b, int n_rows,
                                void* keys, int* done, float* out_val, int* out_idx,
                                void* stream) {
  if (b <= 0) return 0;
  if (n_rows < 0 || (b + kQueryTile - 1) / kQueryTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  unsigned long long* k64 = static_cast<unsigned long long*>(keys);
  const cudaError_t err =
      is_bf16 ? launch(top1_bf16_kernel, 1, kMmaWarps * 32, bf16_bytes, qf,
                       static_cast<const uint16_t*>(g), b, n_rows, kMmaRowsPerChunk, k64, done,
                       out_val, out_idx, s)
              : launch(top1_f32_kernel, 0, kWarps * 32, f32_bytes, qf,
                       static_cast<const float*>(g), b, n_rows, kRowsPerChunk, k64, done,
                       out_val, out_idx, s);
  return static_cast<int>(err);
}
