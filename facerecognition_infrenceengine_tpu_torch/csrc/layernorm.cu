// The ViT's residual add and the LayerNorm after it as one pass, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no ViT.  The ViT embedder's
// serving forward (models/vit.py serve_forward) runs every LayerNorm of its
// residual stream through this kernel.  Per row of `width` elements:
//   - with a residual a: h = x + a, summed in f32 and rounded once to the
//     activation dtype (ATen's add), written back into x;
//   - without one (block 0's norm1): h = x, and x is not written;
//   - then n = gamma * ((h - mean) * rstd) + beta in f32, rounded to the
//     dtype and written to out, which may be a's buffer (the fused sites)
//     or x itself.
// The statistics are two passes over the row held in registers, in f32:
// mean = sum(h) / width, then var = sum((h - mean)^2) / width, each sum a
// butterfly of shuffles over the warp, and rstd = rsqrtf(var + eps).  That
// is not ATen's Welford order, so n is within a rounding of F.layer_norm of
// the same h, not equal to it bit for bit (the card tests hold it to one
// bf16 ulp, and the served ViT-L to the module forward by cosine).
//
// Bound on the H100: bytes.  The fused pass reads x and a and writes x and
// n: 4 x 2 bytes an element in bf16.  ViT-L's residual stream at 1,024 crops
// is 147,456 rows of 768, 226,492,416 bytes: 0.2704 ms at 3.35 TB/s a fused
// site, 0.1352 ms for the plain LayerNorm (x read, n written).  gamma and
// beta are 1.5 KB.
//
// Design: one warp a row, so that the statistics need only shuffles: lane l
// holds the row's 4-element vectors l, l + 32, ... (8 bytes in bf16, 16 in
// f32), so a warp's load is a contiguous 256- or 512-byte run.  The whole
// row sits in registers before anything is written, which makes writing n
// over a, or h over x, safe.  Warps walk rows with a grid stride, the grid
// at the blocks the SMs hold at once.  Loads and stores are plain (not the read-only path): x, a and
// out may alias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVec = 8;  // 4-element vectors a lane holds of a row: width <= 1,024
constexpr int kMaxDevices = 16;

struct F32 {
  using S = float;
  using L = uint4;  // 4 elements
  __device__ static float get(S v) { return v; }
  __device__ static S put(float v) { return v; }
};

struct Bf16 {
  using S = uint16_t;
  using L = uint2;  // 4 elements
  __device__ static float get(S v) { return __bfloat162float(__ushort_as_bfloat16(v)); }
  __device__ static S put(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
};

template <typename D>
union Vec {
  typename D::L u;
  typename D::S e[4];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename D, int NV, bool kRes>
__global__ void __launch_bounds__(kThreads)
    residual_layernorm_kernel(typename D::L* x, const typename D::L* a, typename D::L* out,
                              const typename D::L* gamma, const typename D::L* beta, float eps,
                              long long rows) {
  constexpr int kRowVec = 32 * NV;
  constexpr float kWidth = static_cast<float>(kRowVec * 4);
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < rows; row += n_warps) {
    const long long base = row * kRowVec + lane;
    Vec<D> h[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) h[k].u = x[base + 32 * k];
    if constexpr (kRes) {
      Vec<D> r[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) r[k].u = a[base + 32 * k];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          h[k].e[j] = D::put(__fadd_rn(D::get(h[k].e[j]), D::get(r[k].e[j])));
        }
        x[base + 32 * k] = h[k].u;
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += D::get(h[k].e[j]);
    }
    const float mean = warp_sum(sum) / kWidth;
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = D::get(h[k].e[j]) - mean;
        sq = fmaf(d, d, sq);
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / kWidth + eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      Vec<D> g, b, o;
      g.u = gamma[lane + 32 * k];
      b.u = beta[lane + 32 * k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = (D::get(h[k].e[j]) - mean) * rstd;
        o.e[j] = D::put(fmaf(D::get(g.e[j]), t, D::get(b.e[j])));
      }
      out[base + 32 * k] = o.u;
    }
  }
}

// Per device: the SM count and, per kernel instance, the blocks an SM holds
// (0: not asked yet).
constexpr int kSlots = 2 * kMaxVec * 2;
struct DeviceCache {
  int sms = 0;
  int per_sm[kSlots] = {};
};
DeviceCache g_cache[kMaxDevices];

template <typename D, int NV, bool kRes>
cudaError_t launch_one(void* x, const void* a, void* out, const void* gamma, const void* beta,
                       float eps, long long rows, int slot, cudaStream_t s) {
  auto kernel = residual_layernorm_kernel<D, NV, kRes>;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  DeviceCache& c = g_cache[dev];
  if (c.sms == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      c.sms = 0;
      return err;
    }
  }
  int& per_sm = c.per_sm[slot];
  if (per_sm == 0) {
    int n = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm = n > 0 ? n : 1;
  }
  using L = typename D::L;
  const long long wanted = (rows + kWarps - 1) / kWarps;
  const long long resident = static_cast<long long>(per_sm) * c.sms;
  const int blocks = static_cast<int>(wanted < resident ? wanted : resident);
  kernel<<<blocks, kThreads, 0, s>>>(static_cast<L*>(x), static_cast<const L*>(a),
                                     static_cast<L*>(out), static_cast<const L*>(gamma),
                                     static_cast<const L*>(beta), eps, rows);
  return cudaGetLastError();
}

template <typename D, bool kRes>
cudaError_t launch_res(void* x, const void* a, void* out, const void* gamma, const void* beta,
                       float eps, long long rows, int nv, int base, cudaStream_t s) {
  const int slot = base + (kRes ? kMaxVec : 0) + nv - 1;
  switch (nv) {
#define FRE_LAYERNORM_CASE(N) \
  case N:                     \
    return launch_one<D, N, kRes>(x, a, out, gamma, beta, eps, rows, slot, s);
    FRE_LAYERNORM_CASE(1)
    FRE_LAYERNORM_CASE(2)
    FRE_LAYERNORM_CASE(3)
    FRE_LAYERNORM_CASE(4)
    FRE_LAYERNORM_CASE(5)
    FRE_LAYERNORM_CASE(6)
    FRE_LAYERNORM_CASE(7)
    FRE_LAYERNORM_CASE(8)
#undef FRE_LAYERNORM_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename D>
cudaError_t launch(void* x, const void* a, void* out, const void* gamma, const void* beta,
                   float eps, long long rows, int nv, int base, cudaStream_t s) {
  return a == nullptr ? launch_res<D, false>(x, a, out, gamma, beta, eps, rows, nv, base, s)
                      : launch_res<D, true>(x, a, out, gamma, beta, eps, rows, nv, base, s);
}

}  // namespace

// x [rows, width] contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// aligned to 4 elements.  a: null (no residual: x is only read), or
// [rows, width] of the same dtype, added into x.  out [rows, width]: the
// LayerNorm of the (updated) x; it may be a or x.  gamma, beta: [width] in
// the activation dtype.  width must be a multiple of 128 (32 lanes' 4-element
// vectors), at most 1,024.
extern "C" int fre_residual_layernorm(void* x, const void* a, void* out, const void* gamma,
                                      const void* beta, float eps, int is_bf16, long long rows,
                                      int width, void* stream) {
  if (rows < 0 || width <= 0 || width % 128 != 0 || width / 128 > kMaxVec || x == nullptr ||
      out == nullptr || gamma == nullptr || beta == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const int nv = width / 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<Bf16>(x, a, out, gamma, beta, eps, rows, nv, 2 * kMaxVec, s)
              : launch<F32>(x, a, out, gamma, beta, eps, rows, nv, 0, s);
  return static_cast<int>(err);
}
