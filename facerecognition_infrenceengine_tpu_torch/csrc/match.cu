// K1: fused gallery top-1 (q . g^T with a running max/argmax), for sm_90a.
//
// Replaces the TPU kernel facerecognition_infrenceengine_tpu/ops/
// match_pallas.py::gallery_top1 (body _top1_kernel).  Same function: for
// each query the best f32-accumulated dot product over gallery rows
// [0, n_valid) and its row index; rows >= n_valid are never read (masked
// by index); the lowest index wins a tie; with no valid row the value is
// -inf and the index 0.  Queries are in the gallery's dtype (f32 or bf16);
// products and sums are f32 FFMA, never TF32.
//
// Bound on the H100: at small batch, bytes (the n_valid x 512 gallery read
// once, 128 MB in f32 at 65,536 rows); at large batch, f32 operations
// (2*B*n_valid*512 FLOP at 67 TFLOP/s).  No [B, N] score tensor ever
// reaches device memory.
//
// Design: Hopper runs blocks in parallel with no carried state, so the
// TPU's sequential grid with a scratch accumulator becomes two passes.
// Pass 1: grid (query tiles of 8, row chunks of 128); each block holds its
// 8 queries in registers (each lane owns 16 of the 512 elements, so loads
// are 16-byte and coalesced), its 8 warps stream interleaved rows of the
// chunk, and a transposing warp reduction leaves each lane with one
// query's full dot product in 9 shuffles.  Query tiles vary fastest in the
// grid, so the blocks sharing a row chunk run together and read it through
// L2.  Each block writes one (max, lowest index) per query.  Pass 2 merges
// the chunks with one warp a query, by value then lowest index.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDim = 512;
constexpr int kQueries = 8;     // queries per block, held in registers
constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 128;
constexpr int kPerLane = kDim / 32;
constexpr unsigned kFull = 0xffffffffu;

// f32: lane l holds elements 128*t + 4*l + e (t < 4, e < 4).
__device__ __forceinline__ void load_row(const float* p, int lane, float v[kPerLane]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + 128 * t + 4 * lane));
    v[4 * t + 0] = x.x;
    v[4 * t + 1] = x.y;
    v[4 * t + 2] = x.z;
    v[4 * t + 3] = x.w;
  }
}

// bf16: lane l holds elements 256*t + 8*l + e (t < 2, e < 8), widened to f32
// exactly (a bf16 is the high half of an f32).
__device__ __forceinline__ void load_row(const uint16_t* p, int lane, float v[kPerLane]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + 256 * t + 8 * lane));
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[8 * t + 2 * e] = __uint_as_float(w[e] << 16);
      v[8 * t + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

// a[q] holds this lane's partial dot for query q.  Returns the full dot of
// query (bit4, bit3, bit2 of lane) summed over all 32 lanes.
__device__ __forceinline__ float transpose_reduce(float a[kQueries], int lane) {
  bool hi = lane & 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi ? a[i] : a[i + 4];
    const float keep = hi ? a[i + 4] : a[i];
    a[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  hi = lane & 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi ? a[i] : a[i + 2];
    const float keep = hi ? a[i + 2] : a[i];
    a[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  hi = lane & 4;
  {
    const float send = hi ? a[0] : a[1];
    const float keep = hi ? a[1] : a[0];
    a[0] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  a[0] += __shfl_xor_sync(kFull, a[0], 2);
  a[0] += __shfl_xor_sync(kFull, a[0], 1);
  return a[0];
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
top1_partial_kernel(const T* __restrict__ q, const T* __restrict__ g, int b,
                    int n_rows, float* __restrict__ part_val,
                    int* __restrict__ part_idx) {
  const int q0 = blockIdx.x * kQueries;
  const int chunk = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qv[kQueries][kPerLane];
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    if (q0 + k < b) {
      load_row(q + static_cast<size_t>(q0 + k) * kDim, lane, qv[k]);
    } else {
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) qv[k][e] = 0.0f;
    }
  }
  const int my_q = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  const int row_end = min((chunk + 1) * kRowsPerBlock, n_rows);

  float best = -INFINITY;
  int best_idx = 0x7fffffff;
  int row = chunk * kRowsPerBlock + warp;
  float gv[kPerLane];
  if (row < row_end) load_row(g + static_cast<size_t>(row) * kDim, lane, gv);
  while (row < row_end) {
    const int next = row + kWarps;
    float gn[kPerLane];
    if (next < row_end) load_row(g + static_cast<size_t>(next) * kDim, lane, gn);
    float acc[kQueries];
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) s = fmaf(qv[k][e], gv[e], s);
      acc[k] = s;
    }
    const float score = transpose_reduce(acc, lane);
    if (score > best) {  // rows rise within a warp: strict '>' keeps the lowest
      best = score;
      best_idx = row;
    }
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) gv[e] = gn[e];
    row = next;
  }

  __shared__ float s_val[kWarps][kQueries];
  __shared__ int s_idx[kWarps][kQueries];
  if ((lane & 3) == 0) {
    s_val[warp][my_q] = best;
    s_idx[warp][my_q] = best_idx;
  }
  __syncthreads();
  if (threadIdx.x < kQueries && q0 + threadIdx.x < b) {
    const int k = threadIdx.x;
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int w = 0; w < kWarps; ++w) {  // warps interleave rows: break ties by index
      const float v = s_val[w][k];
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
// keeps (max, lowest index), then a butterfly over the warp merges them by
// value, then index -- the lowest index wins a tie, as across chunks in row
// order.  No chunk (n_valid = 0): -inf and index 0.
constexpr int kMergeWarps = 4;

__global__ void __launch_bounds__(kMergeWarps * 32)
top1_merge_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                  int b, int chunks, float* __restrict__ out_val,
                  int* __restrict__ out_idx) {
  const int k = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= b) return;  // whole warps leave together
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int c = lane; c < chunks; c += 32) {  // rising chunks: strict '>' keeps the lowest
    const float v = part_val[static_cast<size_t>(c) * b + k];
    if (v > bv) {
      bv = v;
      bi = part_idx[static_cast<size_t>(c) * b + k];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(kFull, bv, off);
    const int ix = __shfl_xor_sync(kFull, bi, off);
    if (v > bv || (v == bv && ix < bi)) {
      bv = v;
      bi = ix;
    }
  }
  if (lane == 0) {
    out_val[k] = bv;
    out_idx[k] = bi == 0x7fffffff ? 0 : bi;
  }
}

}  // namespace

extern "C" int fre_gallery_top1_rows_per_block() { return kRowsPerBlock; }

// q [b, 512] and g [>= n_rows, 512], both f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), contiguous; part_* hold chunks * b entries, chunks =
// ceil(n_rows / 128).  Writes out_val [b] f32 and out_idx [b] int32.
extern "C" int fre_gallery_top1(const void* q, const void* g, int is_bf16, int b,
                                int n_rows, int chunks, float* part_val,
                                int* part_idx, float* out_val, int* out_idx,
                                void* stream) {
  if (b <= 0) return 0;
  if (n_rows < 0 || chunks < 0 || static_cast<long long>(chunks) * kRowsPerBlock < n_rows ||
      chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    const dim3 grid((b + kQueries - 1) / kQueries, chunks);
    if (is_bf16) {
      top1_partial_kernel<uint16_t><<<grid, kWarps * 32, 0, s>>>(
          static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(g), b,
          n_rows, part_val, part_idx);
    } else {
      top1_partial_kernel<float><<<grid, kWarps * 32, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(g), b, n_rows,
          part_val, part_idx);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  top1_merge_kernel<<<(b + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, s>>>(
      part_val, part_idx, b, chunks, out_val, out_idx);
  return static_cast<int>(cudaGetLastError());
}
