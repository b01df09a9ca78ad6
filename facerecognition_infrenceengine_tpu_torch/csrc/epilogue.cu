// The embedder's per-channel epilogues as one pass, for sm_90a.
//
// IResNet's serving forward (models/arcface.py serve_forward) runs every
// BatchNorm, PReLU and residual add between its convolutions through this
// kernel: y = BN_a(x), then optionally + BN_b(r) or + r, then optionally
// PReLU(alpha), written to out -- which may be x itself, so that an
// epilogue allocates nothing.  The BatchNorms use eval statistics (f32
// weight, bias, running mean and variance).  Activations are channels-last
// ([rows, C] in memory), bf16 or f32.
//
// Rounding follows ATen's sequence of separate passes, so that the result
// equals the module forward's bit for bit:
//   - BatchNorm: invstd = rsqrtf(var + eps) and
//     fma(w * (x - mean), invstd, bias) in f32, rounded to the activation
//     dtype (batch_norm_calc_invstd and
//     batch_norm_transform_input_channels_last_kernel);
//   - the residual: the two rounded BatchNorm outputs (or the BN output and
//     r) summed in f32, rounded;
//   - PReLU: t > 0 ? t : round(float(alpha) * t), alpha in the activation
//     dtype (prelu_kernel).
//
// Bound on the H100: bytes.  Each element is read and written once: 2 + 2
// bytes in bf16 (+ 2 for r), 8 (+ 4) in f32.  IResNet-50's 112 x 112 x 64
// slab at B = 1,024 is 1.64 GB in bf16: 0.98 ms at 3.35 TB/s for BN + PReLU
// in place, 1.47 ms for BN + BN(r) (measured on an H100 at 700 W: 1.13 and
// 1.66 ms, 87% and 88% of the bound).  The parameters are a few KB.
//
// Design: a grid-stride loop over 16-byte vectors (8 bf16 or 4 f32
// channels of one row).  The grid's thread count is a multiple of the
// vectors a row holds (the wrapper asks that they divide the block), so a
// thread's channels are the same at every step: it reads its channels'
// parameters once, computes invstd as ATen does, and holds them in
// registers.  Each step loads kUnroll vectors (and their residuals) before
// computing any, to keep enough bytes in flight at two blocks an SM (the
// heaviest instance, BN + BN(r) + PReLU in bf16, takes 112 registers).
// Loads and stores are plain (not the read-only path): x and out alias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int kMaxDevices = 16;

struct F32 {
  using S = float;
  static constexpr int kVec = 4;
  __device__ static float get(S v) { return v; }
  __device__ static S put(float v) { return v; }
};

struct Bf16 {
  using S = uint16_t;
  static constexpr int kVec = 8;
  __device__ static float get(S v) { return __bfloat162float(__ushort_as_bfloat16(v)); }
  __device__ static S put(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
};

// v rounded to the activation dtype, as f32
template <typename D>
__device__ __forceinline__ float rnd(float v) { return D::get(D::put(v)); }

template <typename D>
union Vec {
  uint4 u;
  typename D::S e[D::kVec];
};

struct Bn {
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
};

struct BnTerms {
  float w, m, inv, s;
};

__device__ __forceinline__ BnTerms bn_terms(const Bn& bn, int c) {
  BnTerms t;
  t.w = bn.weight[c];
  t.s = bn.bias[c];
  t.m = bn.mean[c];
  t.inv = rsqrtf(__fadd_rn(bn.var[c], bn.eps));
  return t;
}

__device__ __forceinline__ float bn_apply(const BnTerms& t, float v) {
  return __fmaf_rn(__fmul_rn(t.w, __fsub_rn(v, t.m)), t.inv, t.s);
}

// kRes: 0 no residual, 1 + r, 2 + BN_b(r).
template <typename D, int kRes, bool kPrelu>
__global__ void __launch_bounds__(kThreads, 2)
    epilogue_kernel(const uint4* x, uint4* out, const uint4* r, Bn a, Bn b,
                    const typename D::S* alpha, long long n_vec, int vec_per_row) {
  constexpr int V = D::kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int c0 = static_cast<int>(i % vec_per_row) * V;
  BnTerms ta[V], tb[kRes == 2 ? V : 1];
  float al[kPrelu ? V : 1];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ta[j] = bn_terms(a, c0 + j);
    if constexpr (kRes == 2) tb[j] = bn_terms(b, c0 + j);
    if constexpr (kPrelu) al[j] = D::get(alpha[c0 + j]);
  }
  for (; i < n_vec; i += kUnroll * stride) {
    Vec<D> xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long idx = i + k * stride;
      if (idx < n_vec) {
        xv[k].u = x[idx];
        if constexpr (kRes != 0) rv[k].u = r[idx];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long idx = i + k * stride;
      if (idx >= n_vec) continue;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float t = rnd<D>(bn_apply(ta[j], D::get(xv[k].e[j])));
        if constexpr (kRes == 1) t = rnd<D>(__fadd_rn(t, D::get(rv[k].e[j])));
        if constexpr (kRes == 2) {
          t = rnd<D>(__fadd_rn(t, rnd<D>(bn_apply(tb[j], D::get(rv[k].e[j])))));
        }
        if constexpr (kPrelu) {
          if (!(t > 0.0f)) t = rnd<D>(__fmul_rn(al[j], t));
        }
        xv[k].e[j] = D::put(t);
      }
      out[idx] = xv[k].u;
    }
  }
}

// Per device: the SM count and, per kernel instance, the blocks an SM holds
// (0: not asked yet).
struct DeviceCache {
  int sms = 0;
  int per_sm[12] = {};
};
DeviceCache g_cache[kMaxDevices];

template <typename D, int kRes, bool kPrelu>
cudaError_t launch_one(const void* x, void* out, const void* r, const Bn& a, const Bn& b,
                       const void* alpha, long long n_vec, int vec_per_row, int slot,
                       cudaStream_t s) {
  auto kernel = epilogue_kernel<D, kRes, kPrelu>;
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
  const long long wanted = (n_vec + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * c.sms;
  const int blocks = static_cast<int>(wanted < resident ? wanted : resident);
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), static_cast<const uint4*>(r), a, b,
      static_cast<const typename D::S*>(alpha), n_vec, vec_per_row);
  return cudaGetLastError();
}

template <typename D>
cudaError_t launch(const void* x, void* out, const void* r, const Bn& a, const Bn& b,
                   bool res_bn, const void* alpha, long long n_vec, int vec_per_row,
                   int base, cudaStream_t s) {
  const bool prelu = alpha != nullptr;
  const int res = r == nullptr ? 0 : (res_bn ? 2 : 1);
  const int slot = base + res * 2 + (prelu ? 1 : 0);
#define FRE_EPILOGUE_CASE(R, P) \
  if (res == R && prelu == P)   \
    return launch_one<D, R, P>(x, out, r, a, b, alpha, n_vec, vec_per_row, slot, s);
  FRE_EPILOGUE_CASE(0, false)
  FRE_EPILOGUE_CASE(0, true)
  FRE_EPILOGUE_CASE(1, false)
  FRE_EPILOGUE_CASE(1, true)
  FRE_EPILOGUE_CASE(2, false)
  FRE_EPILOGUE_CASE(2, true)
#undef FRE_EPILOGUE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out [rows, c] channels-last activations, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), 16-byte aligned; out may be x.  r: null, or a residual of
// the same shape, added as is (b_mean null) or through BN_b.  alpha: null,
// or c PReLU slopes in the activation dtype.  BN parameters are f32 [c].
// c must be a multiple of the vector (4 f32, 8 bf16), and c / vector must
// divide 256.
extern "C" int fre_epilogue(const void* x, void* out, const void* r, const void* alpha,
                            int is_bf16, long long rows, int c, const float* a_w,
                            const float* a_b, const float* a_mean, const float* a_var, float a_eps,
                            const float* b_w, const float* b_b, const float* b_mean,
                            const float* b_var, float b_eps, void* stream) {
  const int vec = is_bf16 ? Bf16::kVec : F32::kVec;
  if (rows < 0 || c <= 0 || c % vec != 0 || kThreads % (c / vec) != 0 || a_w == nullptr ||
      a_b == nullptr || a_mean == nullptr || a_var == nullptr ||
      (r != nullptr && b_mean != nullptr &&
       (b_w == nullptr || b_b == nullptr || b_var == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_vec = rows * (c / vec);
  if (n_vec == 0) return 0;
  const Bn a{a_w, a_b, a_mean, a_var, a_eps};
  const Bn b{b_w, b_b, b_mean, b_var, b_eps};
  const bool res_bn = r != nullptr && b_mean != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<Bf16>(x, out, r, a, b, res_bn, alpha, n_vec, c / vec, 6, s)
              : launch<F32>(x, out, r, a, b, res_bn, alpha, n_vec, c / vec, 0, s);
  return static_cast<int>(err);
}
