// K2: fused int8 gallery top-1 (s8 q . s8 g^T with a running max/argmax on
// the raw s32), for sm_90a.
//
// Replaces the TPU kernel facerecognition_infrenceengine_tpu/ops/
// match_pallas.py::gallery_top1_int8 (body _top1_int8_kernel).  Same
// function: the gallery is int8 with one global scale and the queries are
// int8 with one per-batch scale (quantized by the wrapper, as the reference
// quantizes outside its pallas_call), so the raw s32 dot is monotonic in
// the true score for every row.  For each query: the largest raw dot over
// rows [0, n_valid) and its row; rows >= n_valid are never read; the lowest
// index wins a tie; with no valid row the value is -inf and the index 0;
// the value is float(raw) * (query scale * gallery scale).  The query
// quantization is the reference's: qs = max(max|q|, 1e-12) / 127 over the
// whole batch, q_int = clip(rint(q / qs), -127, 127), with IEEE division.
// All else is integer, so the result equals the plain version bit for bit.
//
// Bound on the H100: bytes.  The n_valid x 512 int8 gallery is read once
// (25.6 MB at 50,000 rows: 7.6 us at 3.35 TB/s); the 2*B*n_valid*512 int8
// operations take 0.83 us at B = 32 even at the 1,979 TOP/s tensor-core
// rate.  No [B, N] score tensor reaches device memory.
//
// Design (simple first, the structure of K1 in match.cu): one block
// quantizes the batch (a max-reduce, then the elementwise rint); pass 1 runs a
// grid of (query tiles of 16, row chunks of 128); each lane holds 16 bytes
// of each of the tile's 16 queries in registers and takes __dp4a over the
// matching 16 bytes of a row (one coalesced 512-byte load a row a warp);
// a transposing warp reduction leaves each lane pair with one query's full
// s32 dot in 16 shuffles.  Warps take interleaved rows, keep (max, lowest
// row) with a strict '>', and the block merges its warps by value then
// index.  Pass 2 merges the chunks with one warp a query, by value then
// lowest row, and scales the winner.
// mma.sync / wgmma on s8 is later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDim = 512;        // bytes a row
constexpr int kQueries = 16;     // queries per block, held in registers
static_assert(kQueries == 16, "transpose_reduce and my_q assume 16 queries");
constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int4 load16(const int8_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// One halving exchange: lanes with bit `off` set keep the upper half of a[0,
// 2*half) and send the lower half to their partner, which keeps the lower
// half; each kept value gains the partner's.  Constant indices only, so a[]
// stays in registers.
template <int half>
__device__ __forceinline__ void halve(int a[], bool hi, int off) {
#pragma unroll
  for (int i = 0; i < half; ++i) {
    const int lo_v = a[i];
    const int hi_v = a[i + half];
    a[i] = (hi ? hi_v : lo_v) + __shfl_xor_sync(kFull, hi ? lo_v : hi_v, off);
  }
}

// a[k] holds this lane's partial dot for query k.  Halving exchanges over
// lane offsets 16, 8, 4, 2 leave lane l with the sum over 16 lanes of query
// ((l>>4)&1)*8 + ((l>>3)&1)*4 + ((l>>2)&1)*2 + ((l>>1)&1); a last exchange
// over offset 1 completes it.
__device__ __forceinline__ int transpose_reduce(int a[kQueries], int lane) {
  halve<8>(a, lane & 16, 16);
  halve<4>(a, lane & 8, 8);
  halve<2>(a, lane & 4, 4);
  halve<1>(a, lane & 2, 2);
  return a[0] + __shfl_xor_sync(kFull, a[0], 1);
}

constexpr int kQuantThreads = 1024;

// One block: qs = max(max|q|, 1e-12) / 127, then q_int = clip(rint(q / qs)).
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const float* __restrict__ q, int n, int8_t* __restrict__ q_int,
                float* __restrict__ qs_out) {
  __shared__ float s_max[kQuantThreads / 32];
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += kQuantThreads) m = fmaxf(m, fabsf(q[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.0f;
  for (int w = 0; w < kQuantThreads / 32; ++w) m = fmaxf(m, s_max[w]);
  const float qs = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
  if (threadIdx.x == 0) *qs_out = qs;
  for (int i = threadIdx.x; i < n; i += kQuantThreads) {
    const float r = rintf(__fdiv_rn(q[i], qs));  // round half to even
    q_int[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
}

__global__ void __launch_bounds__(kWarps * 32)
top1_int8_partial_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ g,
                         int b, int n_rows, int* __restrict__ part_val,
                         int* __restrict__ part_idx) {
  const int q0 = blockIdx.x * kQueries;
  const int chunk = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int qv[kQueries][4];
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    int4 x = make_int4(0, 0, 0, 0);
    if (q0 + k < b) x = load16(q + static_cast<size_t>(q0 + k) * kDim + 16 * lane);
    qv[k][0] = x.x;
    qv[k][1] = x.y;
    qv[k][2] = x.z;
    qv[k][3] = x.w;
  }
  const int my_q = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2 +
                   ((lane >> 1) & 1);
  const int row_end = min((chunk + 1) * kRowsPerBlock, n_rows);

  int best = INT_MIN;  // below every real dot (|dot| <= 512 * 127^2)
  int best_idx = INT_MAX;
  int row = chunk * kRowsPerBlock + warp;
  int4 gv = make_int4(0, 0, 0, 0);
  if (row < row_end) gv = load16(g + static_cast<size_t>(row) * kDim + 16 * lane);
  while (row < row_end) {
    const int next = row + kWarps;
    int4 gn = make_int4(0, 0, 0, 0);
    if (next < row_end) gn = load16(g + static_cast<size_t>(next) * kDim + 16 * lane);
    int acc[kQueries];
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      int s = __dp4a(qv[k][0], gv.x, 0);
      s = __dp4a(qv[k][1], gv.y, s);
      s = __dp4a(qv[k][2], gv.z, s);
      acc[k] = __dp4a(qv[k][3], gv.w, s);
    }
    const int score = transpose_reduce(acc, lane);
    if (score > best) {  // rows rise within a warp: strict '>' keeps the lowest
      best = score;
      best_idx = row;
    }
    gv = gn;
    row = next;
  }

  __shared__ int s_val[kWarps][kQueries];
  __shared__ int s_idx[kWarps][kQueries];
  if ((lane & 1) == 0) {
    s_val[warp][my_q] = best;
    s_idx[warp][my_q] = best_idx;
  }
  __syncthreads();
  if (threadIdx.x < kQueries && q0 + threadIdx.x < b) {
    const int k = threadIdx.x;
    int bv = INT_MIN;
    int bi = INT_MAX;
    for (int w = 0; w < kWarps; ++w) {  // warps interleave rows: break ties by index
      const int v = s_val[w][k];
      const int ix = s_idx[w][k];
      if (v > bv || (v == bv && ix < bi)) {
        bv = v;
        bi = ix;
      }
    }
    part_val[static_cast<size_t>(chunk) * b + q0 + k] = bv;
    part_idx[static_cast<size_t>(chunk) * b + q0 + k] = bi;
  }
}

// Pass 2: one warp a query.  Lanes take chunks lane, lane + 32, ...; each
// keeps (max, lowest row), then a butterfly over the warp merges them by
// value, then row -- the lowest row wins a tie, as across chunks in row
// order.  The winner is scaled; no chunk (n_valid = 0): -inf and row 0.
constexpr int kMergeWarps = 4;

__global__ void __launch_bounds__(kMergeWarps * 32)
top1_int8_merge_kernel(const int* __restrict__ part_val, const int* __restrict__ part_idx,
                       int b, int chunks, const float* __restrict__ qs, float gallery_scale,
                       float* __restrict__ out_val, int* __restrict__ out_idx) {
  const int k = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= b) return;  // whole warps leave together
  int bv = INT_MIN;
  int bi = INT_MAX;
  for (int c = lane; c < chunks; c += 32) {  // rising chunks: strict '>' keeps the lowest
    const int v = part_val[static_cast<size_t>(c) * b + k];
    if (v > bv) {
      bv = v;
      bi = part_idx[static_cast<size_t>(c) * b + k];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int v = __shfl_xor_sync(kFull, bv, off);
    const int ix = __shfl_xor_sync(kFull, bi, off);
    if (v > bv || (v == bv && ix < bi)) {
      bv = v;
      bi = ix;
    }
  }
  if (lane == 0) {
    const bool none = bi == INT_MAX;
    // exact: |dot| < 2^24; -inf stays -inf under the positive scale
    out_val[k] = (none ? -INFINITY : static_cast<float>(bv)) * __fmul_rn(*qs, gallery_scale);
    out_idx[k] = none ? 0 : bi;
  }
}

}  // namespace

extern "C" int fre_gallery_top1_int8_rows_per_block() { return kRowsPerBlock; }

// q [b, 512] f32 and g [>= n_rows, 512] int8, contiguous, 16-byte aligned;
// q_int [b, 512] int8 and qs [1] f32 are scratch; part_* hold chunks * b
// entries, chunks = ceil(n_rows / 128).  Writes the scaled best dot (-inf
// with no row) to out_val [b] and its row to out_idx [b].
extern "C" int fre_gallery_top1_int8(const void* q, const void* g, float gallery_scale, int b,
                                     int n_rows, int chunks, void* q_int, float* qs,
                                     int* part_val, int* part_idx, float* out_val,
                                     int* out_idx, void* stream) {
  if (b <= 0) return 0;
  if (n_rows < 0 || chunks < 0 || static_cast<long long>(chunks) * kRowsPerBlock < n_rows ||
      chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_kernel<<<1, kQuantThreads, 0, s>>>(static_cast<const float*>(q), b * kDim,
                                               static_cast<int8_t*>(q_int), qs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunks > 0) {
    const dim3 grid((b + kQueries - 1) / kQueries, chunks);
    top1_int8_partial_kernel<<<grid, kWarps * 32, 0, s>>>(
        static_cast<const int8_t*>(q_int), static_cast<const int8_t*>(g), b, n_rows,
        part_val, part_idx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  top1_int8_merge_kernel<<<(b + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, s>>>(
      part_val, part_idx, b, chunks, qs, gallery_scale, out_val, out_idx);
  return static_cast<int>(cudaGetLastError());
}
